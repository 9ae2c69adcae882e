"""Polynomial root finding and interpolation on the host (counterpart of
ceres_tpu/utils/polynomial.py; polynomial.cc): the roots for the subspace
dogleg's boundary problem, and the interpolating polynomial of function
samples and its minimum on an interval for the host line search. Plain
numpy: it runs between device steps on a handful of scalars.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

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


def evaluate_polynomial(poly: Sequence[float], x: float) -> float:
    return float(np.polyval(np.asarray(poly), x))


def differentiate_polynomial(poly: Sequence[float]) -> np.ndarray:
    return np.polyder(np.asarray(poly, dtype=np.float64))


def minimize_polynomial(poly: Sequence[float], x_min: float,
                        x_max: float) -> Tuple[float, float]:
    """The polynomial's least value on [x_min, x_max] and where it is
    (polynomial.cc MinimizePolynomial): the interval's ends and the real
    critical points inside it."""
    poly = np.asarray(poly, dtype=np.float64)
    candidates = [x_min, x_max]
    if poly.size > 2:
        real, imag = find_polynomial_roots(differentiate_polynomial(poly))
        for r, im in zip(real, imag):
            if abs(im) < 1e-12 and x_min <= r <= x_max:
                candidates.append(float(r))
    values = [evaluate_polynomial(poly, c) for c in candidates]
    i = int(np.argmin(values))
    return candidates[i], values[i]


@dataclasses.dataclass
class FunctionSample:
    """A sample of phi at x: its value and gradient, each valid or not
    (function_sample.h)."""

    x: float = 0.0
    value: float = 0.0
    gradient: float = 0.0
    value_is_valid: bool = False
    gradient_is_valid: bool = False

    @staticmethod
    def value_only(x, value):
        return FunctionSample(x=x, value=value, value_is_valid=True)

    @staticmethod
    def with_gradient(x, value, gradient):
        return FunctionSample(x=x, value=value, gradient=gradient,
                              value_is_valid=True, gradient_is_valid=True)


def find_interpolating_polynomial(samples: List[FunctionSample]) -> np.ndarray:
    """The polynomial of least degree that meets every valid value and
    gradient of the samples, by least squares (polynomial.cc
    FindInterpolatingPolynomial); coefficients highest power first."""
    num_constraints = (sum(s.value_is_valid for s in samples)
                       + sum(s.gradient_is_valid for s in samples))
    degree = num_constraints - 1
    n = degree + 1
    A, b = [], []
    for s in samples:
        if s.value_is_valid:
            A.append(np.array([s.x ** (degree - j) for j in range(n)]))
            b.append(s.value)
        if s.gradient_is_valid:
            A.append(np.array([(degree - j) * s.x ** (degree - j - 1)
                               if degree - j >= 1 else 0.0 for j in range(n)]))
            b.append(s.gradient)
    sol, *_ = np.linalg.lstsq(np.asarray(A), np.asarray(b), rcond=None)
    return sol


def minimize_interpolating_polynomial(samples: List[FunctionSample], x_min: float,
                                      x_max: float) -> Tuple[float, float]:
    """The interpolating polynomial's minimum on [x_min, x_max], or a
    sample inside the interval whose value is lower (polynomial.cc
    MinimizeInterpolatingPolynomial)."""
    x, v = minimize_polynomial(find_interpolating_polynomial(samples), x_min, x_max)
    for s in samples:
        if s.value_is_valid and x_min <= s.x <= x_max and s.value < v:
            x, v = s.x, s.value
    return x, v
