"""Iteration callbacks and the per-iteration log lines (counterpart of
ceres_tpu/callbacks.py; iteration_callback.h:194, callbacks.cc:45-75).

The fused loop prints `trust_region_log_line` for each row of the summary
after the solve when Options.minimizer_progress_to_stdout is set, as the
JAX fused loop does (fused_lm.py:1762-1766). User IterationCallbacks and
EvaluationCallbacks run in the host loop, a later slice of the port:
Options.callbacks and Options.evaluation_callback raise naming it.
"""
from __future__ import annotations

from .summary import IterationSummary
from .types import CallbackReturnType


class IterationCallback:
    """Subclass and override __call__(iteration_summary) -> CallbackReturnType."""

    def __call__(self, summary: IterationSummary) -> CallbackReturnType:
        raise NotImplementedError


class EvaluationCallback:
    """A user hook run before each residual and Jacobian evaluation
    (evaluation_callback.h:63)."""

    def prepare_for_evaluation(self, evaluate_jacobians: bool,
                               new_evaluation_point: bool) -> None:
        raise NotImplementedError


def trust_region_log_line(s: IterationSummary) -> str:
    """LoggingCallback's trust-region format (callbacks.cc)."""
    return (
        f"iter {s.iteration:4d}  cost {s.cost: .8e}  cost_change {s.cost_change: .2e}  "
        f"|gradient| {s.gradient_max_norm: .2e}  |step| {s.step_norm: .2e}  "
        f"tr_ratio {s.relative_decrease: .2e}  tr_radius {s.trust_region_radius: .2e}  "
        f"ls_iter {s.linear_solver_iterations:3d}  iter_time {s.iteration_time_in_seconds: .2e}  "
        f"total_time {s.cumulative_time_in_seconds: .2e}"
    )


def line_search_log_line(s: IterationSummary) -> str:
    return (
        f"iter {s.iteration:4d}  cost {s.cost: .8e}  cost_change {s.cost_change: .2e}  "
        f"|gradient| {s.gradient_max_norm: .2e}  |step| {s.step_norm: .2e}  "
        f"f_evals {s.line_search_function_evaluations:3d}  "
        f"g_evals {s.line_search_gradient_evaluations:3d}  "
        f"iter_time {s.iteration_time_in_seconds: .2e}  "
        f"total_time {s.cumulative_time_in_seconds: .2e}"
    )
