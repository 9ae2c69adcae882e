"""SPARSE_NORMAL_CHOLESKY: J'J + D^2 by the inner-product computer, the
factor by the native sparse Cholesky (counterpart of
ceres_tpu/solvers/linear/sparse_normal.py;
sparse_normal_cholesky_solver.cc:58).

The values of J'J + D^2 and J'r are formed on the device
(ops/inner_product.py: kernels 6 and 7; J'r by the flat ops' kernels 6,
7 and 9), brought to the host as float64 in one transfer, factored and
solved by ceres_tpu_torch/native with the symbolic analysis of the
pattern kept across solves; y goes back to the device. Mixed precision
factors in float32 and refines in float64 (RefinedSparseCholesky).
Dynamic sparsity (dynamic_sparse_normal_cholesky_solver.cc:48) drops the
entries that are numerically zero, keeping the diagonal, and analyzes the
pruned pattern anew at every solve.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ... import native
from ...ops.inner_product import InnerProductComputer
from ...types import LinearSolverTerminationType


class SparseNormalCholeskySolver:
    def __init__(self, meta, flat_ops, use_mixed_precision: bool = False,
                 max_num_refinement_iterations: int = 3, dynamic: bool = False):
        self.meta = meta
        self.flat = flat_ops
        self.ipc = InnerProductComputer(meta, flat_ops.device)
        self.mixed = use_mixed_precision
        self.refine = max(1, max_num_refinement_iterations)
        self.dynamic = dynamic
        self.chol = None if dynamic else self._make_backend(self.ipc.indptr,
                                                            self.ipc.indices)

    def _make_backend(self, indptr, indices):
        if self.mixed:
            return native.RefinedSparseCholesky(
                self.ipc.n, indptr, indices, max_num_refinement_iterations=self.refine)
        return native.SparseCholesky(self.ipc.n, indptr, indices)

    def _dynamic_backend(self, vals: np.ndarray):
        """A factorization analyzed on the pruned numeric pattern, and its
        values."""
        indptr, indices = self.ipc.indptr, self.ipc.indices
        rows = np.repeat(np.arange(self.ipc.n), np.diff(indptr))
        keep = (vals != 0.0) | (indices == rows)
        new_indptr = np.concatenate(
            [[0], np.cumsum(np.add.reduceat(keep, indptr[:-1]))]).astype(np.int64)
        return self._make_backend(new_indptr, indices[keep]), vals[keep]

    def solve(self, vflat, residuals: torch.Tensor, D: torch.Tensor, to_host: Callable):
        """min |J y - r|^2 + |D y|^2 for the flattened blocks vflat:
        (y on the device, termination); y is None where the factorization
        fails or y is not finite. `to_host` brings device tensors to the
        host as float64 arrays (one counted sync)."""
        vals_t = self.ipc.compute(vflat, D)
        rhs_t = self.flat.left(vflat, residuals)
        vals, rhs = to_host(vals_t, rhs_t)
        native.STATS["dtoh_bytes"] += vals_t.nbytes + rhs_t.nbytes
        chol = self.chol
        if self.dynamic:
            chol, vals = self._dynamic_backend(vals)
        if not chol.factorize(vals):
            return None, LinearSolverTerminationType.FAILURE
        y = chol.solve(rhs)
        if not np.all(np.isfinite(y)):
            return None, LinearSolverTerminationType.FAILURE
        return torch.as_tensor(y, device=residuals.device), LinearSolverTerminationType.SUCCESS
