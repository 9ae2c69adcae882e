"""Cost functions (counterpart of ceres_tpu/cost_function.py).

A cost function is a torch callable; its Jacobians come from forward-mode
autodiff (`torch.func.jacfwd`, AutoDiffCostFunction), the user's own
(AnalyticCostFunction) or finite differences (NumericDiffCostFunction),
batched over every residual block of a kind by `torch.func.vmap`. A cost
may carry `residual_rows`, the row-vectorized form of the same residual
that the fused evaluation recognises (models/bal.py).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .types import NumericDiffMethodType


class CostFunction:
    num_residuals: int
    parameter_block_sizes: tuple
    residual_rows: Optional[Callable] = None

    def residuals(self, params, data=None) -> torch.Tensor:
        raise NotImplementedError

    def residuals_and_jacobians(self, params, data=None):
        """One block: (res (r,), [J_i (r, size_i)])."""
        params = tuple(params)

        def f(*ps):
            return self.residuals(ps, data)

        res = f(*params)
        jacs = jacfwd(f, argnums=tuple(range(len(params))))(*params)
        # forward mode promotes the tangent of a 0-d float32 tensor times a
        # Python float to float64; the Jacobian keeps the residual's dtype
        return res, [J.to(res.dtype) for J in jacs]

    def batched_residuals_and_jacobians(self, params, data=None):
        """Every block of a kind at once: params[i] (B, size_i), data
        leaves (B, ...) -> (res (B, r), [J_i (B, r, size_i)])."""
        in_dims = (0, None if data is None else 0)
        return vmap(self.residuals_and_jacobians, in_dims=in_dims)(
            tuple(params), data)


class AutoDiffCostFunction(CostFunction):
    """Wraps a functor f(*params[, data]) -> residuals."""

    def __init__(self, functor: Callable, num_residuals: int,
                 parameter_block_sizes: Sequence[int],
                 name: Optional[str] = None):
        self.functor = functor
        self.num_residuals = int(num_residuals)
        self.parameter_block_sizes = tuple(int(s) for s in parameter_block_sizes)
        self.name = name or getattr(functor, "__name__", "autodiff_cost")
        if self.num_residuals <= 0 or any(s <= 0 for s in self.parameter_block_sizes):
            raise ValueError("cost function sizes must be positive")

    def residuals(self, params, data=None):
        out = self.functor(*params) if data is None else self.functor(*params, data)
        return torch.atleast_1d(out).reshape(self.num_residuals)


class AnalyticCostFunction(CostFunction):
    """Closed-form Jacobians (a SizedCostFunction subclass): subclass and
    override `residuals` and `jacobians`."""

    def jacobians(self, params, data=None):
        raise NotImplementedError

    def residuals_and_jacobians(self, params, data=None):
        return self.residuals(params, data), list(self.jacobians(params, data))


class NumericDiffCostFunction(CostFunction):
    """Finite-difference Jacobians, FORWARD, CENTRAL or RIDDERS
    (cost_function.py:102-228, numeric_diff.h:61-208): per coordinate a
    step of max(sqrt(eps), relative_step_size |x_j|); Ridders' iterated
    Richardson extrapolation over a shrinking step, every candidate step
    evaluated at once and the Neville tableau built unrolled."""

    def __init__(self, functor: Callable, num_residuals: int,
                 parameter_block_sizes: Sequence[int],
                 method="CENTRAL", relative_step_size: float = 1e-6,
                 ridders_relative_initial_step_size: float = 1e-2,
                 max_num_ridders_extrapolations: int = 10,
                 ridders_epsilon: float = 1e-12,
                 ridders_step_shrink_factor: float = 2.0,
                 name: Optional[str] = None):
        self.functor = functor
        self.num_residuals = int(num_residuals)
        self.parameter_block_sizes = tuple(int(s) for s in parameter_block_sizes)
        self.method = NumericDiffMethodType.parse(method)
        self.relative_step_size = relative_step_size
        self.ridders_relative_initial_step_size = ridders_relative_initial_step_size
        self.max_num_ridders_extrapolations = max_num_ridders_extrapolations
        self.ridders_epsilon = ridders_epsilon
        self.ridders_step_shrink_factor = ridders_step_shrink_factor
        self.name = name or getattr(functor, "__name__", "numeric_diff_cost")
        if self.num_residuals <= 0 or any(s <= 0 for s in self.parameter_block_sizes):
            raise ValueError("cost function sizes must be positive")

    def residuals(self, params, data=None):
        out = self.functor(*params) if data is None else self.functor(*params, data)
        return torch.atleast_1d(torch.as_tensor(out)).reshape(self.num_residuals)

    def _eval_perturbed(self, params, data, block_idx, offsets):
        """Residuals with block `block_idx` moved by each row of offsets
        (K, size) -> (K, num_residuals)."""

        def one(offset):
            ps = list(params)
            ps[block_idx] = ps[block_idx] + offset
            return self.residuals(ps, data)

        return vmap(one)(offsets)

    def residuals_and_jacobians(self, params, data=None):
        params = [torch.as_tensor(p) for p in params]
        res = self.residuals(params, data)
        dtype = res.dtype
        min_step = float(np.sqrt(np.finfo(np.float64).eps))
        jacs = []
        for bi, size in enumerate(self.parameter_block_sizes):
            x = params[bi]
            if self.method == NumericDiffMethodType.RIDDERS:
                jacs.append(self._ridders_jacobian(params, data, bi, res))
                continue
            step = torch.clamp(self.relative_step_size * torch.abs(x), min=min_step)
            offsets = torch.eye(size, dtype=dtype, device=res.device) * step[None, :]
            f_plus = self._eval_perturbed(params, data, bi, offsets)  # (size, r)
            if self.method == NumericDiffMethodType.FORWARD:
                J = (f_plus - res[None, :]) / step[:, None]
            else:
                f_minus = self._eval_perturbed(params, data, bi, -offsets)
                J = (f_plus - f_minus) / (2.0 * step[:, None])
            jacs.append(J.T)
        return res, jacs

    def _ridders_jacobian(self, params, data, block_idx, res):
        """(r, size): for each (coordinate, residual) the tableau entry of
        the smallest error estimate (cost_function.py:174-228)."""
        x = params[block_idx]
        size = self.parameter_block_sizes[block_idx]
        r = self.num_residuals
        m = self.max_num_ridders_extrapolations
        shrink = self.ridders_step_shrink_factor
        rel0 = self.ridders_relative_initial_step_size
        base_step = torch.where(torch.abs(x) > 0, torch.abs(x) * rel0,
                                torch.full_like(x, rel0))
        dtype = res.dtype
        eye = torch.eye(size, dtype=dtype, device=res.device)
        ks = torch.as_tensor(shrink ** (-np.arange(m)), dtype=dtype, device=res.device)
        steps = base_step[None, :] * ks[:, None]  # (m, size)
        offs = (steps[:, :, None] * eye[None, :, :]).reshape(m * size, size)
        f_p = self._eval_perturbed(params, data, block_idx, offs)
        f_m = self._eval_perturbed(params, data, block_idx, -offs)
        central = (f_p - f_m).reshape(m, size, r) / (2.0 * steps[:, :, None])
        big = torch.finfo(dtype).max
        best = central[0]
        best_err = torch.full((size, r), big, dtype=dtype, device=res.device)
        prev_row = central[0][None]
        sq = shrink * shrink
        for i in range(1, m):
            row = [central[i]]
            for j in range(1, i + 1):
                fac = sq ** j
                row.append((fac * row[j - 1] - prev_row[j - 1]) / (fac - 1.0))
            row_arr = torch.stack(row)  # (i + 1, size, r)
            err = torch.maximum(torch.abs(row_arr[1:] - row_arr[:-1]),
                                torch.abs(row_arr[1:] - prev_row))
            cand_err, cand_idx = torch.min(err, dim=0)
            cand = torch.take_along_dim(row_arr[1:], cand_idx[None], dim=0)[0]
            better = cand_err < best_err
            best = torch.where(better, cand, best)
            best_err = torch.where(better, cand_err, best_err)
            prev_row = row_arr
        return best.T


def cost_function_to_functor(cost: CostFunction) -> Callable:
    """CostFunctionToFunctor (cost_function_to_functor.h:156): a cost
    function is already a differentiable torch callable, so nesting one in
    another functor is a plain call."""

    def functor(*args):
        if len(args) == len(cost.parameter_block_sizes) + 1:
            *params, data = args
        else:
            params, data = args, None
        return cost.residuals(list(params), data)

    return functor


class ConditionedCostFunction(CostFunction):
    """r_i' = g_i(r_i): one conditioner cost function per residual of the
    wrapped one (conditioned_cost_function.cc)."""

    def __init__(self, wrapped: CostFunction, conditioners: Sequence[CostFunction]):
        if len(conditioners) != wrapped.num_residuals:
            raise ValueError("need one conditioner per residual")
        self.wrapped = wrapped
        self.conditioners = list(conditioners)
        self.num_residuals = wrapped.num_residuals
        self.parameter_block_sizes = wrapped.parameter_block_sizes

    def residuals(self, params, data=None):
        r = self.wrapped.residuals(params, data)
        return torch.stack([c.residuals([r[i:i + 1]], None)[0]
                            for i, c in enumerate(self.conditioners)])


class NormalPrior(CostFunction):
    """r = A (x - b) (normal_prior.cc)."""

    def __init__(self, A, b):
        self.A = torch.as_tensor(np.asarray(A, np.float64))
        self.b = torch.as_tensor(np.asarray(b, np.float64))
        self.num_residuals = int(self.A.shape[0])
        self.parameter_block_sizes = (int(self.b.shape[0]),)

    def residuals(self, params, data=None):
        x = params[0]
        A, b = self.A.to(x.device, x.dtype), self.b.to(x.device, x.dtype)
        return A @ (x - b)
