"""The dense linear solvers of the trust-region step (counterpart of
ceres_tpu/solvers/linear/dense.py) and the reduced-system Cholesky of the
dense-Schur step (the `_factor` / `_compute_step_kernel` solves of
ceres_tpu/solvers/fused_lm.py).

Both systems are small (the reduced camera system is 144 x 144 at BAL-16;
DENSE_QR and DENSE_NORMAL_CHOLESKY run on problems of a few hundred
columns) and the JAX package factors them outside every kernel, so
torch.linalg factors them here. Nothing here waits for the device: a
failed factorisation turns into NaN, which the LM loop reads as an
invalid step.

`qr_solve` and `normal_cholesky_solve` return y minimising
|J y - r|^2 + |D y|^2; the caller negates it (step = -y,
levenberg_marquardt_strategy.cc:113-133).
"""
from __future__ import annotations

import torch


def cholesky_lower(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of S (..., n, n), all NaN for a matrix that
    is not positive definite (cholesky_ex reports failure without a host
    sync)."""
    L, info = torch.linalg.cholesky_ex(S)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


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


def qr_solve(J: torch.Tensor, r: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """DENSE_QR: the QR factorisation of the stacked [J; diag(D)] system
    (dense.py:22)."""
    n = J.shape[1]
    A = torch.cat([J, torch.diag(D)])
    b = torch.cat([r, r.new_zeros((n,))])
    Q, R = torch.linalg.qr(A)
    return torch.linalg.solve_triangular(R, (Q.T @ b)[:, None], upper=True)[:, 0]


def normal_cholesky_solve(J: torch.Tensor, r: torch.Tensor,
                          D: torch.Tensor) -> torch.Tensor:
    """DENSE_NORMAL_CHOLESKY: the Cholesky factorisation of J'J + D'D
    (dense.py:32)."""
    A = J.T @ J + torch.diag(D * D)
    L = cholesky_lower(A)
    return torch.cholesky_solve((J.T @ r)[:, None], L, upper=False)[:, 0]


def normal_cholesky_solve_mixed(J: torch.Tensor, r: torch.Tensor, D: torch.Tensor,
                                refinement_steps: int = 3) -> torch.Tensor:
    """DENSE_NORMAL_CHOLESKY in mixed precision (dense.py:42-62, the
    RefinedDenseCholesky of dense_cholesky.h:198-249): J'J + D'D formed in
    float64, factored in float32, and `refinement_steps` passes of float64
    iterative refinement through the float32 factor."""
    A = J.T @ J + torch.diag(D * D)
    rhs = J.T @ r
    L32 = cholesky_lower(A.to(torch.float32))

    def solve32(b):
        return torch.cholesky_solve(b.to(torch.float32)[:, None], L32,
                                    upper=False)[:, 0].to(torch.float64)

    y = solve32(rhs)
    for _ in range(refinement_steps):
        y = y + solve32(rhs - A @ y)
    return y
