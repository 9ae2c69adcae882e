"""CGNR: conjugate gradients on the normal equations (J'J + D'D) y = J'b
(counterpart of ceres_tpu/solvers/linear/cgnr.py; cgnr_solver.cc:70-392).

The operator is matrix-free, preconditioned by block Jacobi,
blockdiag(J'J + D^2)^{-1}, or by nothing (IDENTITY). The products, the
preconditioner's blocks and J'b run through `flat_ops`
(ops/flatops.FlatJacobianOps, built once per program): on a BAL-shaped
program the product is one launch of normal_matvec (kernel 4), elsewhere
the right/left chain of kernels 7, 6 and 9. Each CG iteration is one host
sync through `fetch` (solvers/linear/cg.py).
"""
from __future__ import annotations

from typing import Callable

import torch

from .cg import CGResult, conjugate_gradients


def cgnr_solve(flat_ops, vflat, b: torch.Tensor, D: torch.Tensor, *,
               fetch: Callable, q_tolerance: float, r_tolerance: float = -1.0,
               max_num_iterations: int = 500, min_num_iterations: int = 0,
               preconditioner: str = "JACOBI") -> CGResult:
    """min |J y - b|^2 + |D y|^2 by CG on the normal equations, J the
    flattened block values `vflat` of flat_ops's program."""
    fl = flat_ops
    kern = fl.make_kernel_matvec(fl.kernel_lanes(vflat), torch.ones_like(D))
    if kern is not None:
        def lhs(x):
            return kern(x) + (D * D) * x
    else:
        def lhs(x):
            return fl.normal_multiply(vflat, D, x)

    rhs = fl.left(vflat, b)
    precond = None
    if preconditioner == "JACOBI":
        invs = fl.inverse_flats(fl.fams, fl.block_jtj_all(vflat), D)

        def precond(v):
            return fl.apply_inverse_rows(fl.fams, invs, v)

    return conjugate_gradients(
        lhs, rhs, torch.zeros_like(rhs), precond, fetch=fetch,
        min_num_iterations=min_num_iterations, max_num_iterations=max_num_iterations,
        residual_reset_period=10, r_tolerance=r_tolerance, q_tolerance=q_tolerance)
