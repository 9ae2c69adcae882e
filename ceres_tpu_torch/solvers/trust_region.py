"""The host trust-region minimizer: the Levenberg-Marquardt (or dogleg)
outer loop driven from the host (counterpart of
ceres_tpu/solvers/trust_region.py; trust_region_minimizer.cc:68-847,
levenberg_marquardt_strategy.cc:69-180, trust_region_step_evaluator.cc).

The JAX package runs it for small problems, callbacks, dumps and a solve
time limit (solver.py `_maybe_build_fused`); the port runs it for the
same cases. Control flow (accept or reject, tolerances, radius, the
callbacks) runs on the host on float64 scalars; the array work runs on
the device through a kernels object: `DenseTrustRegionKernels` here for
DENSE_QR and DENSE_NORMAL_CHOLESKY, `BlockTrustRegionKernels`
(solvers/bsr_kernels.py) for the Schur, sparse and CGNR solvers. Each reads what
the host needs in one fetch per step: the evaluation's cost and gradient
norms, the step's finiteness and model cost change, the candidate's cost
and norms, so an LM iteration waits for the device about three times, a
CG iteration once more, a line-search probe once more. Every wait is
counted in `Summary.num_host_syncs`.

Semantics kept from the JAX loop: Jacobi column scaling from iteration
0; the LM diagonal; model-cost validity; non-monotonic step evaluation;
the radius rules; bounds by projection in Plus, the active-set mask of
the scale (`_update_effective_scale`) and the projected Armijo line
search (`_projected_line_search`); the callbacks, solve time limit and
iteration dumps; the termination taxonomy and its messages; inner
iterations (trust_region.py:404-419): coordinate descent
(solvers/coordinate_descent.py) on each candidate, its cost change folded
into the model cost change, a step that the inner iterations made useful
accepted, and the inner iterations turned off once their relative
progress falls to inner_iteration_tolerance (one more sync per candidate
they run on).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..callbacks import run_callbacks
from ..options import Options
from ..summary import IterationSummary, Summary
from ..types import LinearSolverTerminationType, TerminationType, TrustRegionStrategyType

_DBL_MAX = float(np.finfo(np.float64).max)


class TrustRegionStepEvaluator:
    """Non-monotonic step acceptance (trust_region_step_evaluator.{h,cc})."""

    def __init__(self, initial_cost: float, max_consecutive_nonmonotonic_steps: int):
        self.max_steps = max_consecutive_nonmonotonic_steps
        self.minimum_cost = initial_cost
        self.current_cost = initial_cost
        self.reference_cost = initial_cost
        self.candidate_cost = initial_cost
        self.acc_reference_model_cost_change = 0.0
        self.acc_candidate_model_cost_change = 0.0
        self.num_consecutive_nonmonotonic_steps = 0

    def step_quality(self, cost: float, model_cost_change: float) -> float:
        if cost >= _DBL_MAX:
            return -_DBL_MAX
        with np.errstate(all="ignore"):
            relative_decrease = (np.float64(self.current_cost) - cost) / np.float64(
                model_cost_change)
            historical = (np.float64(self.reference_cost) - cost) / (
                np.float64(self.acc_reference_model_cost_change) + model_cost_change)
        return float(max(relative_decrease, historical))

    def step_accepted(self, cost: float, model_cost_change: float):
        self.current_cost = cost
        self.acc_candidate_model_cost_change += model_cost_change
        self.acc_reference_model_cost_change += model_cost_change
        if self.current_cost < self.minimum_cost:
            self.minimum_cost = self.current_cost
            self.num_consecutive_nonmonotonic_steps = 0
            self.candidate_cost = self.current_cost
            self.acc_candidate_model_cost_change = 0.0
        else:
            self.num_consecutive_nonmonotonic_steps += 1
            if self.current_cost > self.candidate_cost:
                self.candidate_cost = self.current_cost
                self.acc_candidate_model_cost_change = 0.0
        if self.num_consecutive_nonmonotonic_steps == self.max_steps:
            self.reference_cost = self.candidate_cost
            self.acc_reference_model_cost_change = self.acc_candidate_model_cost_change


@dataclasses.dataclass
class StepResult:
    delta: Optional[torch.Tensor] = None
    model_cost_change: float = 0.0
    termination: LinearSolverTerminationType = LinearSolverTerminationType.SUCCESS
    num_iterations: int = 1


class LevenbergMarquardtStrategy:
    """The LM regularization and radius bookkeeping
    (levenberg_marquardt_strategy.cc:69-180)."""

    def __init__(self, options: Options):
        self.radius = options.initial_trust_region_radius
        self.max_radius = options.max_trust_region_radius
        self.decrease_factor = 2.0
        self.reuse_diagonal = False
        self._diagonal = None

    def compute_step(self, m: "TrustRegionMinimizer") -> StepResult:
        scale = m.effective_scale
        if not self.reuse_diagonal or self._diagonal is None:
            self._diagonal = m.k.lm_diagonal(m.jacobian, scale)
        self.reuse_diagonal = True
        step, delta, mcc, num_iters = m.k.compute_step(
            m.jacobian, m.residuals, scale, self._diagonal, self.radius, m.fetch)
        finite, mcc_f = m.fetch(torch.isfinite(step).all(), mcc)
        if finite == 0.0:
            return StepResult(termination=LinearSolverTerminationType.FAILURE)
        return StepResult(delta=delta, model_cost_change=mcc_f,
                          termination=LinearSolverTerminationType.SUCCESS,
                          num_iterations=int(num_iters))

    def step_accepted(self, step_quality: float):
        assert step_quality > 0.0
        self.radius = self.radius / max(1.0 / 3.0, 1.0 - (2.0 * step_quality - 1.0) ** 3)
        self.radius = min(self.max_radius, self.radius)
        self.decrease_factor = 2.0
        self.reuse_diagonal = False

    def step_rejected(self, step_quality: float):
        self.radius = self.radius / self.decrease_factor
        self.decrease_factor *= 2.0
        self.reuse_diagonal = True

    def step_is_invalid(self):
        self.step_rejected(0.0)


def grad_norms(program, x: torch.Tensor, g: torch.Tensor):
    """(|x - Plus(x, -g)|, its max norm), in the ambient space
    (trust_region.py:160-175, fused_lm.py:1396-1400)."""
    dx = x - program.plus(x, -g.to(torch.float64))
    if dx.numel() == 0:
        z = torch.zeros((), dtype=torch.float64, device=x.device)
        return z, z
    return torch.linalg.vector_norm(dx), torch.max(torch.abs(dx))


def active_set_mask(program):
    """For a bounded program, mask(x, g): 0 on the tangent coordinates that
    sit on a bound with the gradient pushing outward, else 1, in float64
    (trust_region.py:536-558, fused_lm.py:1368-1378); None without bounds.
    Both loops solve the step in the free subspace through it."""
    if not program.has_bounds():
        return None
    tmap_np, lo_np, hi_np = program.tangent_box()
    dev = program.device
    tmap = torch.as_tensor(tmap_np, device=dev)
    lo, hi = torch.as_tensor(lo_np, device=dev), torch.as_tensor(hi_np, device=dev)
    boxed = tmap >= 0
    take = torch.clamp(tmap, min=0)

    def mask(x, g):
        xv = torch.where(boxed, x[take], torch.zeros_like(lo))
        g64 = g.to(torch.float64)
        active = boxed & (((xv <= lo) & (g64 > 0.0)) | ((xv >= hi) & (g64 < 0.0)))
        return torch.where(active, 0.0, 1.0).to(torch.float64)

    return mask


class _CandidateMixin:
    """The candidate point and the cost probes, shared by both kernels."""

    def candidate(self, x, delta):
        """(x [+] delta, its cost (0-d f64), |x - candidate|)."""
        cx = self.program.plus(x, delta.to(torch.float64))
        return cx, self.program.evaluate_cost(cx), torch.linalg.vector_norm(x - cx)

    def cost_at(self, x, delta):
        return self.program.evaluate_cost(self.program.plus(x, delta.to(torch.float64)))


class DenseTrustRegionKernels(_CandidateMixin):
    """The dense-Jacobian step (trust_region.py:144): J (N, tangent)
    assembled in float64 at each evaluation, the scaled system solved by
    `linear_solver` (solvers/linear/dense.py: DENSE_QR, or
    DENSE_NORMAL_CHOLESKY with or without mixed-precision solves)."""

    def __init__(self, program, linear_solver, options: Options):
        self.program = program
        self.options = options
        self.linear_solver = linear_solver

    def eval_full(self, x):
        """(cost, residuals, gradient f64, J, |gradient|, max |gradient|)
        in the ambient projection of trust_region.py:160-175."""
        o = self.program._eval_core(x, dense_jac=True)
        J, r = o["jacobian"], o["residuals"]
        g = J.T @ r.to(J.dtype)
        gnorm, gmax = grad_norms(self.program, x, g)
        return o["cost"], r, g, J, gnorm, gmax

    @staticmethod
    def jacobi_scale(J):
        """1 / (1 + |column|) (trust_region_minimizer.cc:272)."""
        return 1.0 / (1.0 + torch.sqrt(torch.sum(J * J, dim=0)))

    def lm_diagonal(self, J, scale):
        Js = J * scale[None, :]
        return torch.clamp(torch.sum(Js * Js, dim=0), self.options.min_lm_diagonal,
                           self.options.max_lm_diagonal)

    def compute_step(self, J, residuals, scale, diagonal, radius, fetch):
        """(step, delta = step * scale, model cost change, 1)."""
        Js = J * scale[None, :]
        D = torch.sqrt(diagonal / radius)
        r = residuals.to(Js.dtype)
        step = -self.linear_solver(Js, r, D.to(Js.dtype))
        mr = Js @ step
        return step, step * scale, -torch.dot(mr, r + mr / 2.0), 1

    @staticmethod
    def right_multiply(J, v):
        return J @ v.to(J.dtype)

    @staticmethod
    def left_multiply(J, u):
        return u.to(J.dtype) @ J

    @staticmethod
    def dense_jacobian(J):
        return J


class TrustRegionMinimizer:
    """The host-side outer loop (trust_region_minimizer.cc:68-160)."""

    def __init__(self, program, kernels, options: Options, summary: Summary,
                 inner_minimizer=None):
        self.program = program
        self.k = kernels
        self.inner_minimizer = inner_minimizer
        if hasattr(kernels, "to_host"):  # the sparse steps bring values to the host
            kernels.to_host = self.to_host
        self.options = options
        self.summary = summary
        self.x_cost = float("nan")

    def fetch(self, *scalars):
        """The device scalars as host floats: one host sync, counted."""
        self.summary.num_host_syncs += 1
        return torch.stack([torch.as_tensor(s).to(torch.float64).reshape(())
                            for s in scalars]).tolist()

    def to_host(self, *tensors):
        """The device tensors as float64 numpy arrays: one host sync."""
        self.summary.num_host_syncs += 1
        return [t.detach().to("cpu", torch.float64).numpy() for t in tensors]

    def _notify(self, it_summary: IterationSummary) -> Optional[TerminationType]:
        return run_callbacks(self.options, it_summary, self.summary, self.program, self.x)

    def minimize(self, x0: torch.Tensor) -> torch.Tensor:
        opts = self.options
        summary = self.summary
        start = time.monotonic()
        self.x = x0
        self.x_cost = float("nan")  # defined even if iteration zero fails
        strategy = LevenbergMarquardtStrategy(opts)
        if opts.trust_region_strategy_type == TrustRegionStrategyType.DOGLEG:
            from .dogleg import DoglegStrategy

            strategy = DoglegStrategy(opts)
        self._strategy = strategy
        self._mask = active_set_mask(self.program)
        inner_enabled = self.inner_minimizer is not None

        it = IterationSummary(iteration=0, step_is_valid=False, eta=opts.eta)
        iteration_start = start

        # iteration zero: project x onto the feasible set, evaluate
        if self._mask is not None:
            self.x = self.k.candidate(self.x, torch.zeros(
                self.program.tangent_size, dtype=torch.float64, device=x0.device))[0]
        if self._evaluate_gradient_and_jacobian(first=True) is None:
            summary.message = "Initial residual and Jacobian evaluation failed."
            summary.termination_type = TerminationType.FAILURE
            return self.x
        it.cost = self.x_cost
        it.gradient_norm = self.gradient_norm
        it.gradient_max_norm = self.gradient_max_norm
        it.step_is_valid = True
        it.step_is_successful = True
        summary.initial_cost = self.x_cost
        step_evaluator = TrustRegionStepEvaluator(
            self.x_cost,
            opts.max_consecutive_nonmonotonic_steps if opts.use_nonmonotonic_steps else 0)
        num_consecutive_invalid_steps = 0
        minimum_cost = self.x_cost
        best_x = self.x
        atleast_one_successful_step = False

        while True:
            # FinalizeIterationAndCheckIfMinimizerCanContinue
            if it.step_is_successful:
                summary.num_successful_steps += 1
                if self.x_cost < minimum_cost:
                    minimum_cost = self.x_cost
                    best_x = self.x
                    it.step_is_nonmonotonic = False
                else:
                    it.step_is_nonmonotonic = True
            else:
                summary.num_unsuccessful_steps += 1
            it.trust_region_radius = strategy.radius
            now = time.monotonic()
            it.iteration_time_in_seconds = now - iteration_start
            it.cumulative_time_in_seconds = (now - start) + summary.preprocessor_time_in_seconds
            summary.iterations.append(it)

            cb = self._notify(it)
            if cb is not None:
                summary.termination_type = cb
                break
            total_time = (time.monotonic() - start) + summary.preprocessor_time_in_seconds
            if total_time >= opts.max_solver_time_in_seconds:
                summary.message = (
                    f"Maximum solver time reached. Total solver time: {total_time:e} >= "
                    f"{opts.max_solver_time_in_seconds:e}.")
                summary.termination_type = TerminationType.NO_CONVERGENCE
                break
            if it.iteration >= opts.max_num_iterations:
                summary.message = ("Maximum number of iterations reached. Number of "
                                   f"iterations: {it.iteration}.")
                summary.termination_type = TerminationType.NO_CONVERGENCE
                break
            if it.step_is_successful and it.gradient_max_norm <= opts.gradient_tolerance:
                summary.message = (
                    f"Gradient tolerance reached. Gradient max norm: "
                    f"{it.gradient_max_norm:e} <= {opts.gradient_tolerance:e}")
                summary.termination_type = TerminationType.CONVERGENCE
                break
            if it.trust_region_radius <= opts.min_trust_region_radius:
                summary.message = (
                    f"Minimum trust region radius reached. Trust region radius: "
                    f"{it.trust_region_radius:e} <= {opts.min_trust_region_radius:e}")
                summary.termination_type = TerminationType.CONVERGENCE
                break

            iteration_start = time.monotonic()
            prev_gradient_norm = it.gradient_norm
            prev_gradient_max_norm = it.gradient_max_norm
            it = IterationSummary(iteration=it.iteration + 1, eta=opts.eta,
                                  step_is_valid=False)

            # -- ComputeTrustRegionStep ------------------------------------
            solver_start = time.monotonic()
            step_result = strategy.compute_step(self)
            it.step_solver_time_in_seconds = time.monotonic() - solver_start
            summary.linear_solver_time_in_seconds += it.step_solver_time_in_seconds
            summary.num_linear_solves += 1
            if step_result.termination == LinearSolverTerminationType.FATAL_ERROR:
                summary.message = "Linear solver failed due to unrecoverable non-numeric causes."
                summary.termination_type = TerminationType.FAILURE
                break
            it.linear_solver_iterations = step_result.num_iterations
            if it.iteration in opts.trust_region_minimizer_iterations_to_dump:
                self._dump_iteration(it.iteration, strategy, step_result)
            if step_result.termination != LinearSolverTerminationType.FAILURE:
                it.step_is_valid = step_result.model_cost_change > 0.0
            if it.step_is_valid:
                delta = step_result.delta
                model_cost_change = step_result.model_cost_change
                num_consecutive_invalid_steps = 0

            if not it.step_is_valid:
                # HandleInvalidStep
                num_consecutive_invalid_steps += 1
                if num_consecutive_invalid_steps >= opts.max_num_consecutive_invalid_steps:
                    summary.message = (
                        "Number of consecutive invalid steps more than "
                        "Solver::Options::max_num_consecutive_invalid_steps: "
                        f"{opts.max_num_consecutive_invalid_steps}")
                    summary.termination_type = TerminationType.FAILURE
                    break
                strategy.step_is_invalid()
                it.cost = self.x_cost
                it.cost_change = 0.0
                it.gradient_max_norm = prev_gradient_max_norm
                it.gradient_norm = prev_gradient_norm
                it.step_norm = 0.0
                it.relative_decrease = 0.0
                it.step_is_successful = False
                continue

            # -- the projected line search of a bounded problem ---------------
            if self._mask is not None and opts.max_num_line_search_step_size_iterations > 0:
                delta = self._projected_line_search(delta)

            # -- the candidate point ---------------------------------------------
            cand_x, cand_cost_t, step_norm_t = self.k.candidate(self.x, delta)
            candidate_cost, it.step_norm, x_norm = self.fetch(
                cand_cost_t, step_norm_t, torch.linalg.vector_norm(self.x))
            if not np.isfinite(candidate_cost):
                candidate_cost = _DBL_MAX

            # -- inner iterations (coordinate descent) --------------------------
            inner_were_useful = False
            if inner_enabled and candidate_cost < _DBL_MAX:
                t0 = time.monotonic()
                summary.num_inner_iteration_steps += 1
                new_x = self.inner_minimizer.minimize(cand_x)
                (inner_cost,) = self.fetch(self.k.cost_at(new_x, torch.zeros_like(delta)))
                if np.isfinite(inner_cost):
                    model_cost_change += candidate_cost - inner_cost
                    inner_were_useful = inner_cost < min(self.x_cost, candidate_cost)
                    inner_enabled = (1.0 - inner_cost / candidate_cost
                                     > opts.inner_iteration_tolerance)
                    cand_x, candidate_cost = new_x, inner_cost
                summary.inner_iteration_time_in_seconds += time.monotonic() - t0

            # -- convergence checks -----------------------------------------------
            if atleast_one_successful_step:
                step_size_tolerance = opts.parameter_tolerance * (
                    x_norm + opts.parameter_tolerance)
                if it.step_norm <= step_size_tolerance:
                    summary.message = (
                        "Parameter tolerance reached. Relative step_norm: "
                        f"{it.step_norm / (x_norm + opts.parameter_tolerance):e} <= "
                        f"{opts.parameter_tolerance:e}.")
                    summary.termination_type = TerminationType.CONVERGENCE
                    summary.iterations.append(it)
                    break
            it.cost_change = self.x_cost - candidate_cost
            if abs(it.cost_change) <= opts.function_tolerance * self.x_cost:
                summary.message = (
                    "Function tolerance reached. |cost_change|/cost: "
                    f"{abs(it.cost_change) / self.x_cost:e} <= {opts.function_tolerance:e}")
                summary.termination_type = TerminationType.CONVERGENCE
                summary.iterations.append(it)
                break

            # -- accept or reject ---------------------------------------------------
            it.relative_decrease = step_evaluator.step_quality(candidate_cost, model_cost_change)
            if inner_were_useful or it.relative_decrease > opts.min_relative_decrease:
                atleast_one_successful_step = True
                self.x = cand_x
                self.x_cost = candidate_cost
                if self._evaluate_gradient_and_jacobian(first=False) is None:
                    summary.message = "Residual and Jacobian evaluation failed."
                    summary.termination_type = TerminationType.FAILURE
                    break
                it.cost = self.x_cost
                it.gradient_norm = self.gradient_norm
                it.gradient_max_norm = self.gradient_max_norm
                it.step_is_successful = True
                strategy.step_accepted(it.relative_decrease)
                step_evaluator.step_accepted(candidate_cost, model_cost_change)
            else:
                it.step_is_successful = False
                it.cost = candidate_cost
                it.gradient_norm = prev_gradient_norm
                it.gradient_max_norm = prev_gradient_max_norm
                strategy.step_rejected(it.relative_decrease)

        # the best point seen (the reference's x_ holds the minimum-cost one)
        if self.x_cost > minimum_cost:
            self.x = best_x
            self.x_cost = minimum_cost
        return self.x

    # ------------------------------------------------------------------

    def _dump_iteration(self, iteration: int, strategy, step_result: StepResult):
        """trust_region_minimizer_iterations_to_dump
        (trust_region_minimizer.cc:387-395): J, D, b and the step of the
        iteration's linear system (utils/dump.py)."""
        from ..utils.dump import dump_linear_least_squares_problem

        base = os.path.join(self.options.trust_region_problem_dump_directory,
                            f"ceres_tpu_iteration_{iteration:03d}")
        J = self.k.dense_jacobian(self.jacobian)
        D = None
        if getattr(strategy, "_diagonal", None) is not None:
            D = torch.sqrt(strategy._diagonal / strategy.radius)
        host = self.to_host(*[t for t in (J, D, self.residuals, step_result.delta)
                              if t is not None])
        J, rest = host[0], host[1:]
        D = rest.pop(0) if D is not None else None
        b = rest.pop(0)
        x = rest.pop(0) if step_result.delta is not None else None
        dump_linear_least_squares_problem(base, J, D=D, b=b, x=x)

    def _evaluate_gradient_and_jacobian(self, first: bool):
        opts = self.options
        t0 = time.monotonic()
        if opts.evaluation_callback is not None:
            opts.evaluation_callback.prepare_for_evaluation(
                evaluate_jacobians=True, new_evaluation_point=True)
        cost, residuals, gradient, J, gnorm, gmax = self.k.eval_full(self.x)
        cost_f, gnorm_f, gmax_f = self.fetch(cost, gnorm, gmax)
        self.summary.jacobian_evaluation_time_in_seconds += time.monotonic() - t0
        self.summary.num_jacobian_evaluations += 1
        if not np.isfinite(cost_f):
            return None
        self.x_cost = cost_f
        self.residuals = residuals
        self.gradient = gradient
        self.jacobian = J
        if first:
            self.scale = (self.k.jacobi_scale(J) if opts.jacobi_scaling else torch.ones(
                self.program.tangent_size, dtype=torch.float64, device=self.x.device))
        self.gradient_norm = gnorm_f
        self.gradient_max_norm = gmax_f
        self._update_effective_scale()
        return True

    def _update_effective_scale(self):
        """The active set of a bounded problem: the scale is zeroed on the
        coordinates that sit on a bound with the gradient pushing outward,
        so the step is solved in the free subspace
        (trust_region.py:536-558), recomputed after every accepted step.
        Here the mask is formed on the device and always applied: a scale
        times 1 is the scale."""
        self.effective_scale = self.scale
        if self._mask is not None:
            self.effective_scale = self.scale * self._mask(self.x, self.gradient).to(
                self.scale.dtype)

    def _projected_line_search(self, delta):
        """Armijo backtracking on the step scale with the bounds' projection
        (trust_region_minimizer.cc:591-645, the simple contraction of
        trust_region.py:560); one host sync per probe, the slope read with
        the first."""
        opts = self.options
        cost0 = self.x_cost
        slope_t = torch.dot(self.gradient.to(torch.float64), delta.to(torch.float64))
        step = 1.0
        best_step, best_cost = None, cost0
        for i in range(opts.max_num_line_search_step_size_iterations):
            c_t = self.k.cost_at(self.x, step * delta)
            if i == 0:
                c, slope = self.fetch(c_t, slope_t)
            else:
                (c,) = self.fetch(c_t)
            if np.isfinite(c) and c <= cost0 + (
                    opts.line_search_sufficient_function_decrease * step * slope):
                best_step, best_cost = step, c
                break
            if np.isfinite(c) and c < best_cost:
                best_step, best_cost = step, c
            step *= 0.5
            if step < opts.min_line_search_step_size:
                break
        if best_step is None:
            return delta
        return best_step * delta
