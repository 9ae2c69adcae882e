"""TinySolver: small dense Levenberg-Marquardt (counterpart of
ceres_tpu/tiny_solver.py; the reference's tiny_solver.h, doc :33-60).

`solve_batch` runs one LM loop over B independent problems at once
(triangulation, per-track refinement): the residuals and their Jacobians
of every lane by `torch.func.vmap` over `torch.func.jacfwd`, the damped
normal equations by a batched Cholesky, and accept, damping and the
stopping tests per lane by `torch.where`. A lane that is done is frozen,
as the JAX package's vmap of its `lax.while_loop` freezes it, so each
lane ends where its own `solve` ends. The loop asks the device one
question an iteration (are all lanes done?); `last_host_syncs` counts
them. `solve` is the loop over a batch of one.

The damping update is Madsen-Nielsen-Tingleff's (tiny_solver.h
Update/Solve): u scaled by max(1/3, 1 - (2 rho - 1)^3) on an accepted
step, by v (then doubled) on a rejected one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from .program import resolve_device
from .utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class TinySolverOptions:
    max_num_iterations: int = 50
    gradient_tolerance: float = 1e-10  # eps^(1/2) in reference terms
    parameter_tolerance: float = 1e-8
    cost_threshold: float = float(torch.finfo(torch.float64).eps)
    initial_trust_region_radius: float = 1e4


class TinySolverSummary(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: torch.Tensor
    gradient_max_norm: torch.Tensor


class _State(NamedTuple):
    x: torch.Tensor  # (B, n)
    r: torch.Tensor  # (B, m)
    J: torch.Tensor  # (B, m, n)
    cost: torch.Tensor
    u: torch.Tensor  # damping
    v: torch.Tensor  # damping growth
    it: torch.Tensor  # int32
    done: torch.Tensor  # bool
    gmax: torch.Tensor


class TinySolver:
    """residual_fn(x, data) -> (m,) residuals over torch tensors. Runs on
    the card unless device="cpu"."""

    def __init__(self, residual_fn: Callable,
                 options: TinySolverOptions = TinySolverOptions(), device=None):
        self.residual_fn = residual_fn
        self.options = options
        self.device = resolve_device(device)
        self.last_host_syncs = 0

    def _eval_rj(self, x, data):
        fn = self.residual_fn

        def one(xb, db):
            return fn(xb, db), torch.func.jacfwd(fn)(xb, db)

        return torch.func.vmap(one, in_dims=(0, None if data is None else 0))(x, data)

    def _step(self, s: _State, data) -> _State:
        """One LM iteration of every lane (tiny_solver.py:78-115)."""
        o = self.options
        Jt = s.J.transpose(-1, -2)
        jtj = Jt @ s.J
        g = (Jt @ s.r[..., None])[..., 0]
        gmax = g.abs().amax(-1)
        n = s.x.shape[-1]
        A = jtj + s.u[:, None, None] * torch.eye(n, dtype=s.x.dtype, device=s.x.device)
        L, info = torch.linalg.cholesky_ex(A)
        dx = -torch.cholesky_solve(g[..., None], L)[..., 0]
        bad = (info != 0) | ~torch.isfinite(dx).all(-1)
        x_new = s.x + torch.where(bad[:, None], torch.zeros_like(dx), dx)
        r_new, J_new = self._eval_rj(x_new, data)
        cost_new = 0.5 * (r_new * r_new).sum(-1)
        # predicted reduction 0.5 dx'(u dx - g) (MNT eq. 2.20)
        pred = 0.5 * (dx * (s.u[:, None] * dx - g)).sum(-1)
        rho = (s.cost - cost_new) / torch.where(pred == 0, torch.full_like(pred, 1e-300), pred)
        accept = (rho > 0) & ~bad & torch.isfinite(cost_new)
        u_acc = s.u * torch.maximum(torch.full_like(rho, 1.0 / 3.0),
                                    1.0 - (2.0 * rho - 1.0) ** 3)
        u = torch.where(accept, u_acc, s.u * s.v)
        v = torch.where(accept, torch.full_like(s.v, 2.0), 2.0 * s.v)
        x = torch.where(accept[:, None], x_new, s.x)
        r = torch.where(accept[:, None], r_new, s.r)
        J = torch.where(accept[:, None, None], J_new, s.J)
        cost = torch.where(accept, cost_new, s.cost)
        it = s.it + 1
        step_norm = torch.linalg.vector_norm(dx, dim=-1)
        x_norm = torch.linalg.vector_norm(s.x, dim=-1)
        done = ((gmax <= o.gradient_tolerance)
                | (accept & (step_norm <= o.parameter_tolerance
                             * (x_norm + o.parameter_tolerance)))
                | (cost <= o.cost_threshold)
                | (it >= o.max_num_iterations))
        new = _State(x, r, J, cost, u, v, it, done, gmax)
        live = ~s.done  # a done lane keeps its state
        return _State(*(torch.where(live.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)
                        for a, b in zip(new, s)))

    def _run(self, x0, data):
        """The LM loop over a batch: (x (B, n), summary of (B,) tensors)."""
        r0, J0 = self._eval_rj(x0, data)
        cost0 = 0.5 * (r0 * r0).sum(-1)
        jtj0 = J0.transpose(-1, -2) @ J0
        u0 = 1.0 / self.options.initial_trust_region_radius * torch.diagonal(
            jtj0, dim1=-2, dim2=-1).amax(-1)
        B = x0.shape[0]
        s = _State(x0, r0, J0, cost0, u0, torch.full_like(cost0, 2.0),
                   torch.zeros(B, dtype=torch.int32, device=x0.device),
                   ~torch.isfinite(cost0), torch.full_like(cost0, float("inf")))
        syncs = 0
        while True:  # a lane done at the start stays as it is
            s = self._step(s, data)
            syncs += 1
            if bool(s.done.all()):
                break
        self.last_host_syncs = syncs
        return s.x, TinySolverSummary(cost0, s.cost, s.it, s.gmax)

    def _data(self, data):
        def leaf(a):
            a = torch.as_tensor(a, device=self.device)
            return a.to(torch.float64) if a.is_floating_point() else a
        return tree_map(leaf, data)

    def solve(self, x0, data=None):
        """(x, TinySolverSummary) of one problem."""
        x0 = torch.as_tensor(x0, dtype=torch.float64, device=self.device)
        data = tree_map(lambda a: a[None], self._data(data))
        x, s = self._run(x0[None], data)
        return x[0], TinySolverSummary(*(a[0] for a in s))

    def solve_batch(self, x0_batch, data_batch):
        """B independent problems in one loop: x0_batch (B, n), data_batch a
        tree of (B, ...) arrays."""
        x0 = torch.as_tensor(x0_batch, dtype=torch.float64, device=self.device)
        return self._run(x0, self._data(data_batch))
