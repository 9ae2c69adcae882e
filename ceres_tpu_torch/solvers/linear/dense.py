"""The reduced-system Cholesky of the dense-Schur step (counterpart of the
parts of ceres_tpu/solvers/linear/dense.py and the `_factor` /
`_compute_step_kernel` solves of ceres_tpu/solvers/fused_lm.py).

The reduced camera system is small (144 x 144 at BAL-16) and outside every
kernel of the JAX package, so torch.linalg factors it. Nothing here waits
for the device: a failed factorisation turns into NaN, which the LM loop
reads as an invalid step.
"""
from __future__ import annotations

import torch


def cholesky_lower(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of S, all NaN where S is not positive
    definite (cholesky_ex reports failure without a host sync)."""
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def tri_inverse_lower(L: torch.Tensor) -> torch.Tensor:
    """Explicit L^{-1} by one n-wide triangular solve against I."""
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def reduced_solve(S: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """z = S^{-1} rhs. float64: Cholesky solve (fused_lm.py:840). float32:
    Cholesky factor, explicit L^{-1} and one refinement pass
    (fused_lm.py:947-960): the f32 L^{-1} apply alone leaves ~1e-4
    relative error."""
    L = cholesky_lower(S)
    if S.dtype == torch.float64:
        return torch.cholesky_solve(rhs[:, None], L, upper=False)[:, 0]
    Linv = tri_inverse_lower(L)
    z = Linv.T @ (Linv @ rhs)
    resid = rhs - S @ z
    return z + Linv.T @ (Linv @ resid)
