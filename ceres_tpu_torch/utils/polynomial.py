"""Polynomial root finding on the host (counterpart of
ceres_tpu/utils/polynomial.py; polynomial.cc FindPolynomialRoots), for
the subspace dogleg's boundary problem. Plain numpy: it runs between
device steps on a handful of scalars. The interpolation helpers of the
JAX module serve the line search and come with it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def find_polynomial_roots(poly) -> Tuple[np.ndarray, np.ndarray]:
    """(real parts, imaginary parts) of the roots of poly[0] x^n + ... +
    poly[n], as the companion matrix's eigenvalues (np.roots)."""
    poly = np.trim_zeros(np.asarray(poly, dtype=np.float64), "f")
    if poly.size == 0:
        raise ValueError("all-zero polynomial")
    if poly.size == 1:
        return np.array([]), np.array([])
    roots = np.roots(poly)
    return roots.real, roots.imag
