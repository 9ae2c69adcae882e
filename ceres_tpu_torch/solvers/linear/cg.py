"""Preconditioned conjugate gradients (counterpart of
ceres_tpu/solvers/linear/cg.py, `conjugate_gradients`).

The same algorithm and semantics as the JAX function and
conjugate_gradients_solver.h: the Nash/Sofer Q-tolerance termination that
the trust-region eta forcing sequence relies on, the r-tolerance check,
min/max iteration counts, a residual refresh every
`residual_reset_period` iterations, the failure taxonomy, and x kept at
the previous iterate on failure or indefiniteness.

The JAX function runs as one `lax.while_loop` on the device. Here the
vectors stay on the device and the host drives the loop: each iteration
ends in ONE fetch of its done flag and termination code, through the
caller's `fetch`, which counts it (`Summary.num_host_syncs`). The check
before the first iteration (zero right-hand side) travels with the first
iteration's fetch. A loop that stays on the device is ROADMAP.md port
slice 4.

`conjugate_gradients_host` is the JAX package's variant for a
preconditioner applied on the host (the SUBSET preconditioner's native
triangular solves): its semantics, with the vectors kept on the device and
the preconditioner moving its vector to the host and back.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

# Termination codes (linear_solver.h:57-74).
CG_NO_CONVERGENCE = 0
CG_SUCCESS = 1
CG_FAILURE = 2


class CGResult(NamedTuple):
    x: torch.Tensor
    num_iterations: int
    termination: int
    final_norm_r: torch.Tensor


def conjugate_gradients(
    lhs: Callable,
    rhs: torch.Tensor,
    x0: torch.Tensor,
    preconditioner: Optional[Callable] = None,
    *,
    fetch: Callable,
    min_num_iterations: int = 0,
    max_num_iterations: int = 100,
    residual_reset_period: int = 10,
    r_tolerance: float = -1.0,
    q_tolerance: float = -1.0,
    host_variant: bool = False,
    dot: Optional[Callable] = None,
    norm: Optional[Callable] = None,
) -> CGResult:
    """Solve lhs(x) = rhs. `fetch(*scalars) -> list of floats` brings device
    scalars to the host; every call is one host sync. `host_variant`:
    conjugate_gradients_host's semantics (below). `dot` and `norm`
    replace the inner product and the 2-norm (cg.py's injectable ones,
    conjugate_gradients_solver.h:109): over vectors sharded across ranks,
    closed by a psum, so that every rank takes the same decisions."""
    if preconditioner is None:
        preconditioner = lambda v: v
    dot = dot or torch.dot
    norm = norm or torch.linalg.vector_norm

    norm_rhs = norm(rhs)
    tol_r = r_tolerance * norm_rhs
    r = rhs - lhs(x0)
    norm_r = norm(r)
    init_done = (norm_r <= tol_r) & (min_num_iterations == 0)
    Q0 = -dot(x0, rhs + r)
    x, p = x0, torch.zeros_like(x0)
    rho = torch.ones((), dtype=rhs.dtype, device=rhs.device)
    codes = torch.tensor([CG_NO_CONVERGENCE, CG_SUCCESS, CG_FAILURE],
                         device=rhs.device)
    it, term, zero_rhs = 0, CG_NO_CONVERGENCE, False
    while True:
        x_prev, norm_r_prev = x, norm_r
        it += 1
        z = preconditioner(r)
        last_rho = rho
        rho = dot(r, z)
        rho_bad = (rho == 0.0) | torch.isinf(rho)
        if it == 1:
            p = z
            beta_bad = torch.zeros_like(rho_bad)
        else:
            beta = rho / last_rho
            p = z + beta * p
            beta_bad = (beta == 0.0) | torch.isinf(beta)
        q = lhs(p)
        pq = dot(p, q)
        indefinite = (pq <= 0.0) | torch.isinf(pq)
        alpha = rho / pq
        alpha_bad = torch.isinf(alpha)
        x = x + alpha * p
        if it % residual_reset_period == 0:
            r = rhs - lhs(x)
        else:
            r = r - alpha * q
        Q1 = -dot(x, rhs + r)
        zeta = it * (Q1 - Q0) / Q1
        if host_variant:
            zeta = torch.where(Q1 != 0.0, zeta, torch.zeros_like(zeta))
        norm_r = norm(r)
        conv = (((zeta < q_tolerance) | (norm_r <= tol_r))
                & (it >= min_num_iterations))
        failure = rho_bad | beta_bad | alpha_bad
        code = torch.where(failure, codes[2], torch.where(conv, codes[1], codes[0]))
        done = failure | indefinite | conv | (it >= max_num_iterations)
        # on failure or indefiniteness, keep the previous iterate
        x = torch.where(failure | indefinite, x_prev, x)
        Q0 = Q1
        if it == 1:
            done_f, code_f, init_f, zero_f = fetch(done, code, init_done,
                                                   norm_rhs == 0.0)
            zero_rhs = zero_f != 0.0
            if init_f != 0.0:
                # done before the first iteration, which therefore never ran
                x, it, norm_r, term = x0, 0, norm_r_prev, CG_SUCCESS
                break
        else:
            done_f, code_f = fetch(done, code)
        term = int(code_f)
        if done_f != 0.0:
            break
    if zero_rhs:  # |b| == 0 -> solution 0
        x, term = torch.zeros_like(x), CG_SUCCESS
        if host_variant:
            it = 0
    return CGResult(x, it, term, norm_r)


def conjugate_gradients_host(lhs: Callable, rhs: torch.Tensor, x0: torch.Tensor,
                             preconditioner: Optional[Callable] = None, *,
                             fetch: Callable, **kw) -> CGResult:
    """The JAX package's `conjugate_gradients_host` (cg.py:37-115): the
    iteration of `conjugate_gradients`, but a zero right-hand side returns
    after no iteration and a zero model value Q1 counts as converged
    (zeta = 0). The vectors stay on the device; `preconditioner` may take
    its vector to the host and back (counting that sync itself)."""
    return conjugate_gradients(lhs, rhs, x0, preconditioner, fetch=fetch,
                               host_variant=True, **kw)
