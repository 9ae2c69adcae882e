"""Cost functions (counterpart of ceres_tpu/cost_function.py).

A cost function is a torch callable; its Jacobians come from forward-mode
autodiff (`torch.func.jacfwd`), batched over every residual block of a
kind by `torch.func.vmap`. A cost may carry `residual_rows`, the
row-vectorized form of the same residual that the fused evaluation
recognises (models/bal.py).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch.func import jacfwd, vmap


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
