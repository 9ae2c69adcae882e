"""Iteration callbacks and the per-iteration log lines (counterpart of
ceres_tpu/callbacks.py; iteration_callback.h:194, callbacks.cc:45-75).

The fused loop prints `trust_region_log_line` for each row of the summary
after the solve when Options.minimizer_progress_to_stdout is set, as the
JAX fused loop does (fused_lm.py:1762-1766). The host loop
(solvers/trust_region.py) calls `run_callbacks` on each row as it is
made: the log line, the state written back into the problem's arrays
under update_state_every_iteration, then the user IterationCallbacks in
order; the EvaluationCallback runs before each Jacobian evaluation there.
"""
from __future__ import annotations

from typing import Optional

from .summary import IterationSummary, Summary
from .types import CallbackReturnType, LoggingType, TerminationType


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


def run_callbacks(options, it_summary: IterationSummary, summary: Summary,
                  program, x) -> Optional[TerminationType]:
    """Logging, the state update and the user callbacks of one row
    (minimizer.cc RunCallbacks, the JAX callbacks.py:54); the termination
    type a callback asks for, else None. `x` is the solver state on the
    device, read only to write it back."""
    if (options.logging_type == LoggingType.PER_MINIMIZER_ITERATION
            and options.minimizer_progress_to_stdout):
        print(trust_region_log_line(it_summary))
    if options.update_state_every_iteration:
        program.write_state(x)
    for cb in options.callbacks:
        ret = cb(it_summary)
        if program.problem.structure_version != program.structure_version:
            # the reference leaves a mid-solve mutation undefined
            # (problem.h: "may not modify the problem while Solve is
            # running"); fail loudly rather than solve a stale structure
            raise RuntimeError(
                "Problem structure was modified during Solve() (inside an "
                "IterationCallback). Mutating the problem mid-solve is not "
                "supported: return SOLVER_TERMINATE_SUCCESSFULLY from the "
                "callback, mutate, and call solve() again (the compiled "
                "program is cached and rebuilt only on structural change).")
        if ret == CallbackReturnType.SOLVER_ABORT:
            summary.message = "User callback returned SOLVER_ABORT."
            return TerminationType.USER_FAILURE
        if ret == CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY:
            summary.message = "User callback returned SOLVER_TERMINATE_SUCCESSFULLY."
            return TerminationType.USER_SUCCESS
    return None
