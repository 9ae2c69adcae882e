"""The minimal functional API (counterpart of ceres_tpu/capi.py).

The reference's C89 binding (c_api.h:123-138) exposes exactly: create and
free a problem, add a residual block from a bare function, solve. This
module keeps that contract for embedders and code generators: plain
functions, no classes in the signatures, the loss given by (name,
parameter), the residuals by a plain torch callable.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from . import loss as loss_mod
from .cost_function import AutoDiffCostFunction, NumericDiffCostFunction
from .options import Options
from .problem import Problem
from .solver import solve as _solve

_LOSSES = {
    "trivial": lambda a: loss_mod.TrivialLoss(),
    "huber": loss_mod.HuberLoss,
    "softl1": loss_mod.SoftLOneLoss,
    "cauchy": loss_mod.CauchyLoss,
    "arctan": loss_mod.ArctanLoss,
    "tukey": loss_mod.TukeyLoss,
}


def ceres_create_problem() -> Problem:
    """ceres_create_problem()."""
    return Problem()


def ceres_free_problem(problem: Problem) -> None:
    """ceres_free_problem(): removes every residual block."""
    for rb in problem.residual_blocks():
        problem.remove_residual_block(rb.rb_id)


def ceres_problem_add_residual_block(
    problem: Problem,
    cost_function: Callable,
    num_residuals: int,
    parameter_block_sizes: Sequence[int],
    parameter_blocks: Sequence[np.ndarray],
    loss_function_name: Optional[str] = None,
    loss_function_parameter: float = 1.0,
    use_numeric_diff: bool = False,
) -> int:
    """ceres_problem_add_residual_block: cost_function is a plain callable
    f(*parameter_blocks) -> residuals over torch tensors (differentiated by
    torch.func unless use_numeric_diff). Constants it creates belong on
    its arguments' device (`torch.tensor(..., device=v.device)`)."""
    if use_numeric_diff:
        cost = NumericDiffCostFunction(cost_function, num_residuals, parameter_block_sizes)
    else:
        cost = AutoDiffCostFunction(cost_function, num_residuals, parameter_block_sizes)
    loss = None
    if loss_function_name:
        loss = _LOSSES[loss_function_name.lower()](loss_function_parameter)
    return problem.add_residual_block(cost, loss, list(parameter_blocks))


def ceres_solve(problem: Problem, max_num_iterations: int = 50,
                minimizer_progress_to_stdout: bool = False, device=None):
    """ceres_solve(); returns the Summary. Runs on the card unless
    device="cpu"."""
    return _solve(
        Options(max_num_iterations=max_num_iterations,
                minimizer_progress_to_stdout=minimizer_progress_to_stdout),
        problem, device=device)
