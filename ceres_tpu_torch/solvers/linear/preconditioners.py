"""Preconditioners of the iterative solvers (counterpart of
ceres_tpu/solvers/linear/preconditioners.py). Ported so far: SUBSET
(subset_preconditioner.h:70, preconditioners.py:431-453). SCHUR_JACOBI and
JACOBI are the iterative steps' own (implicit_schur.py, cgnr.py); the
power-series and cluster preconditioners are ROADMAP.md port slice 6.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ... import native
from ...ops.inner_product import InnerProductComputer


class SubsetPreconditioner:
    """(Q'Q + D^2)^{-1}, Q the rows of J of the selected residual blocks:
    Q'Q + D^2 formed on the device over the whole J'J pattern (the rows
    outside the subset zeroed), factored by the native sparse Cholesky at
    each step, applied on the host. Where the factorization fails, the
    apply is the identity, as the JAX class's."""

    def __init__(self, meta, device, kind_mask: Sequence[bool]):
        self.meta = meta
        self.ipc = InnerProductComputer(meta, device, kind_mask=list(kind_mask))
        self.chol = native.SparseCholesky(self.ipc.n, self.ipc.indptr, self.ipc.indices)
        self._ok = False

    def update(self, vflat_masked, D: torch.Tensor, to_host: Callable) -> bool:
        vals_t = self.ipc.compute(vflat_masked, D)
        (vals,) = to_host(vals_t)
        native.STATS["dtoh_bytes"] += vals_t.nbytes
        self._ok = self.chol.factorize(vals)
        return self._ok

    def make_apply(self, to_host: Callable) -> Callable:
        """v -> (Q'Q + D^2)^{-1} v for a device vector v: v to the host and
        back, one counted sync."""
        if not self._ok:
            return lambda v: v

        def apply(v):
            (vh,) = to_host(v)
            native.STATS["dtoh_bytes"] += v.nbytes
            return torch.as_tensor(self.chol.solve(vh), device=v.device).to(v.dtype)

        return apply
