"""General unconstrained minimization: GradientProblem and its solver
(counterpart of ceres_tpu/gradient_problem.py; gradient_problem.h:92,
gradient_problem_solver.cc:99-167, gradient_problem_evaluator.h).

The user gives a torch function of the parameter vector that returns the
scalar cost. Its gradient is autograd's (torch.func.grad_and_value)
unless the user gives one, the FirstOrderFunction::Evaluate analog; a
manifold takes the gradient to its tangent space. The line-search
minimizers run over an adapter with the program surface they read, cached
on the problem, so a repeated solve reuses it and its fused minimizers.
`solve_gradient_problem` runs on the card unless the caller passes
device="cpu".
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from .manifolds import Manifold
from .options import Options
from .program import resolve_device
from .summary import Summary
from .types import MinimizerType


class GradientProblem:
    """fn(x) -> scalar cost of the (num_parameters,) float64 tensor x, with
    an optional manifold and an optional ambient gradient(x) -> (n,)."""

    def __init__(self, fn: Callable, num_parameters: int,
                 manifold: Optional[Manifold] = None,
                 gradient: Optional[Callable] = None):
        self.fn = fn
        self.gradient = gradient
        self.num_parameters = num_parameters
        self.manifold = manifold
        if manifold is not None and manifold.ambient_size != num_parameters:
            raise ValueError("manifold ambient size mismatch")
        self._cached_programs = {}

    @property
    def num_tangent_parameters(self) -> int:
        return self.manifold.tangent_size if self.manifold else self.num_parameters


class _GradientProgram:
    """What the line-search minimizers read of a program, over a
    GradientProblem on one device (gradient_problem.py:48-87)."""

    def __init__(self, gp: GradientProblem, device: torch.device):
        self.gp = gp
        self.device = device
        self.tangent_size = gp.num_tangent_parameters
        self.state_size = gp.num_parameters
        self._minimizer_cache = {}

    def evaluate_gradient(self, x):
        """(cost, tangent gradient) in float64."""
        if self.gp.gradient is not None:
            c, g = self.gp.fn(x), self.gp.gradient(x)
        else:
            g, c = torch.func.grad_and_value(self.gp.fn)(x)
        if self.gp.manifold is not None:
            g = self.gp.manifold.plus_jacobian(x).T @ g
        return (torch.as_tensor(c, dtype=torch.float64),
                torch.as_tensor(g, dtype=torch.float64))

    def plus(self, x, delta):
        if self.gp.manifold is not None:
            return self.gp.manifold.plus(x, delta)
        return x + delta

    def has_bounds(self) -> bool:
        return False

    def write_state(self, x) -> None:
        pass


def solve_gradient_problem(options: Options, problem: GradientProblem, parameters,
                           summary: Optional[Summary] = None, device=None) -> Summary:
    """GradientProblemSolver::Solve (gradient_problem_solver.cc:99):
    minimizes from `parameters`, a float64 numpy array, which it updates
    in place, and returns the summary. The fused loop runs under
    fused_loop="ALWAYS" (AUTO counts no residuals here, as in the JAX
    package), else the host loop."""
    from .solvers.fused_line_search import build_fused_line_search
    from .solvers.line_search import LineSearchMinimizer

    dev = resolve_device(device)
    if summary is None:
        summary = Summary()
    t0 = time.monotonic()
    summary.minimizer_type = MinimizerType.LINE_SEARCH
    summary.num_parameters = problem.num_parameters
    summary.num_effective_parameters = problem.num_tangent_parameters
    summary.fixed_cost = 0.0
    program = problem._cached_programs.get(str(dev))
    if program is None:
        program = problem._cached_programs[str(dev)] = _GradientProgram(problem, dev)
    summary.preprocessor_time_in_seconds = time.monotonic() - t0
    t1 = time.monotonic()
    minimizer = build_fused_line_search(program, options)
    if minimizer is None:
        minimizer = LineSearchMinimizer(program, options)
    x = minimizer.minimize(torch.as_tensor(np.asarray(parameters, np.float64), device=dev),
                           summary)
    summary.minimizer_time_in_seconds = time.monotonic() - t1
    parameters[...] = x.detach().to("cpu", torch.float64).numpy()
    summary.final_cost = minimizer.x_cost
    summary.total_time_in_seconds = time.monotonic() - t0
    return summary
