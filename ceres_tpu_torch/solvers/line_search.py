"""The host line-search minimizer: LBFGS, BFGS, nonlinear conjugate
gradients or steepest descent with Armijo or strong-Wolfe searches
(counterpart of ceres_tpu/solvers/line_search.py;
line_search_minimizer.cc:87, line_search.cc, line_search_direction.cc,
low_rank_inverse_hessian.cc:62).

The search logic runs on the host on float64 scalars, as in the JAX
package; the iterate, the gradient, the direction and the curvature
history stay on the device, and only the scalars that the JAX host loop
turns into Python floats come back. Each probe of a search is one host
sync (its value and slope). Each iteration adds one more:
after the accepted point's evaluation, its cost, gradient norms, step and
state norms and curvature products come back together with the slope of
the next direction. For LBFGS and BFGS that next direction is formed both
with and without the new curvature pair, and the host keeps the one the
pair's test (s'y > 1e-10) picks, so the decision needs no extra wait.
Every sync is counted in `Summary.num_host_syncs`.

The minimizer reads a program through `evaluate_gradient(x)` (cost and
gradient, float64), `plus(x, delta)`, `tangent_size` and `write_state`:
a CompiledProgram, or the adapter of a GradientProblem
(gradient_problem.py); the solver reads the final cost by
`evaluate_line_cost(x)`.
"""
from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from ..callbacks import run_callbacks
from ..options import Options
from ..summary import IterationSummary, Summary
from ..types import (
    LineSearchDirectionType,
    LineSearchInterpolationType,
    LineSearchType,
    NonlinearConjugateGradientType,
    TerminationType,
)
from ..utils.polynomial import FunctionSample, minimize_interpolating_polynomial

_SY_MIN = 1e-10  # the curvature pair's test (low_rank_inverse_hessian.cc)


def _fetcher(summary: Summary):
    """The device scalars as host floats: one host sync, counted."""
    def fetch(*scalars):
        summary.num_host_syncs += 1
        return torch.stack([torch.as_tensor(s).to(torch.float64).reshape(())
                            for s in scalars]).tolist()
    return fetch


class LineSearchFunction:
    """phi(s) = f(x [+] s d) and phi'(s) = g(x [+] s d) . d (line_search.h
    LineSearchFunction); each probe one host sync."""

    def __init__(self, program, fetch):
        self.program = program
        self.fetch = fetch
        self.x = None
        self.d = None
        self.num_value_evals = 0
        self.num_gradient_evals = 0

    def init(self, x, d):
        self.x = x
        self.d = d

    def value_and_gradient(self, s: float) -> FunctionSample:
        self.num_value_evals += 1
        self.num_gradient_evals += 1
        cost, grad = self.program.evaluate_gradient(self.program.plus(self.x, s * self.d))
        v, g = self.fetch(cost, torch.dot(grad, self.d))
        if not (np.isfinite(v) and np.isfinite(g)):
            return FunctionSample(x=s, value_is_valid=False)
        return FunctionSample.with_gradient(s, v, g)


def _interpolate(interpolation: LineSearchInterpolationType, lo: FunctionSample,
                 hi_x: float, samples: List[FunctionSample], lower: float,
                 upper: float) -> float:
    if interpolation == LineSearchInterpolationType.BISECTION:
        # the contraction rule min(max(0.5 * current.x, min), max)
        # (line_search.cc:217-221)
        return float(np.clip(0.5 * hi_x, lower, upper))
    usable = [s for s in samples if s.value_is_valid]
    if interpolation == LineSearchInterpolationType.QUADRATIC:
        # gradients dropped but at the first sample
        trimmed = []
        for i, s in enumerate(usable):
            t = FunctionSample(x=s.x, value=s.value, value_is_valid=True)
            if i == 0 and s.gradient_is_valid:
                t.gradient, t.gradient_is_valid = s.gradient, True
            trimmed.append(t)
        usable = trimmed
    if len(usable) < 2:
        return 0.5 * (lower + upper)
    x, _ = minimize_interpolating_polynomial(usable[-3:], lower, upper)
    if not np.isfinite(x) or not (lower <= x <= upper):
        return 0.5 * (lower + upper)
    return x


class ArmijoLineSearch:
    """Backtracking with interpolation over the window {initial, current,
    previous if valid} (line_search.cc ArmijoLineSearch, :245-267)."""

    def __init__(self, options: Options):
        self.o = options

    def search(self, fn: LineSearchFunction, step0: float, initial: FunctionSample):
        o = self.o
        current = fn.value_and_gradient(step0)
        previous = None
        descent = initial.gradient
        it = 0
        while (not current.value_is_valid
               or current.value > initial.value
               + o.line_search_sufficient_function_decrease * current.x * descent):
            it += 1
            if it >= o.max_num_line_search_step_size_iterations:
                return None, it
            lower = o.max_line_search_step_contraction * current.x
            upper = o.min_line_search_step_contraction * current.x
            window = [initial, current]
            if previous is not None and previous.value_is_valid:
                window.append(previous)
            new_x = _interpolate(o.line_search_interpolation_type, initial, current.x,
                                 window, lower, upper)
            if new_x < o.min_line_search_step_size:
                return None, it
            previous, current = current, fn.value_and_gradient(new_x)
        return current, it


class WolfeLineSearch:
    """Strong Wolfe: bracketing, then zoom (line_search.cc WolfeLineSearch,
    Nocedal and Wright algorithm 3.6)."""

    def __init__(self, options: Options):
        self.o = options

    def search(self, fn: LineSearchFunction, step0: float, initial: FunctionSample):
        o = self.o
        c1 = o.line_search_sufficient_function_decrease
        c2 = o.line_search_sufficient_curvature_decrease
        phi0, dphi0 = initial.value, initial.gradient
        prev = initial
        current = fn.value_and_gradient(step0)
        evals = 1
        max_evals = o.max_num_line_search_step_size_iterations
        while True:
            if not current.value_is_valid or (
                    current.value > phi0 + c1 * current.x * dphi0
                    or (prev is not initial and current.value >= prev.value)):
                lo, hi = prev, current
                break
            if abs(current.gradient) <= c2 * abs(dphi0):
                return current, evals
            if current.gradient >= 0:
                lo, hi = current, prev
                break
            if evals >= max_evals:
                return (current if current.value_is_valid else None), evals
            prev, current = current, fn.value_and_gradient(
                current.x * o.max_line_search_step_expansion)
            evals += 1

        while evals < max_evals:
            lower, upper = min(lo.x, hi.x), max(lo.x, hi.x)
            if upper - lower < o.min_line_search_step_size:
                return (lo if lo.value_is_valid else None), evals
            new_x = _interpolate(o.line_search_interpolation_type, lo, max(lo.x, hi.x),
                                 [s for s in (lo, hi) if s.value_is_valid],
                                 lower + 0.01 * (upper - lower),
                                 upper - 0.01 * (upper - lower))
            trial = fn.value_and_gradient(new_x)
            evals += 1
            if not trial.value_is_valid:
                hi = FunctionSample(x=new_x, value=np.inf, value_is_valid=True)
                continue
            if trial.value > phi0 + c1 * trial.x * dphi0 or trial.value >= lo.value:
                hi = trial
            else:
                if abs(trial.gradient) <= c2 * abs(dphi0):
                    return trial, evals
                if trial.gradient * (hi.x - lo.x) >= 0:
                    hi = lo
                lo = trial
        return (lo if lo.value_is_valid and lo.x > 0 else None), evals


class LowRankInverseHessian:
    """The LBFGS two-loop recursion over the last `max_rank` curvature
    pairs, on the device (low_rank_inverse_hessian.cc:62). `push` adds a
    pair whose test (s'y > 1e-10) the caller made, its products given."""

    def __init__(self, max_rank: int, use_approximate_eigenvalue_scaling: bool):
        self.max_rank = max_rank
        self.use_approx = use_approximate_eigenvalue_scaling
        self.s: list = []
        self.y: list = []
        self.rho: list = []
        self.approx_eigenvalue_scale = 1.0

    def copy(self) -> "LowRankInverseHessian":
        out = LowRankInverseHessian(self.max_rank, self.use_approx)
        out.s, out.y, out.rho = list(self.s), list(self.y), list(self.rho)
        out.approx_eigenvalue_scale = self.approx_eigenvalue_scale
        return out

    def push(self, delta_x, delta_g, sy, yy) -> None:
        if len(self.s) == self.max_rank:
            self.s.pop(0)
            self.y.pop(0)
            self.rho.pop(0)
        self.s.append(delta_x)
        self.y.append(delta_g)
        self.rho.append(1.0 / sy)
        self.approx_eigenvalue_scale = sy / yy

    def right_multiply(self, g):
        q = g.clone()
        alphas = []
        for s, y, rho in zip(reversed(self.s), reversed(self.y), reversed(self.rho)):
            a = rho * torch.dot(s, q)
            alphas.append(a)
            q = q - a * y
        if self.use_approx or self.s:
            q = q * self.approx_eigenvalue_scale
        for s, y, rho, a in zip(self.s, self.y, self.rho, reversed(alphas)):
            b = rho * torch.dot(y, q)
            q = q + (a - b) * s
        return q


def _bfgs_pushed(H, initialized: bool, s_vec, y_vec, sy, yy):
    """The dense BFGS inverse Hessian after the pair (s, y), the first one
    scaling the identity by s'y / y'y (line_search_direction.cc)."""
    if not initialized:
        H = H * (sy / torch.clamp(yy, min=1e-300))
    rho = 1.0 / sy
    V = torch.eye(H.shape[0], dtype=H.dtype, device=H.device) - rho * torch.outer(s_vec, y_vec)
    return V @ H @ V.T + rho * torch.outer(s_vec, s_vec)


class LineSearchMinimizer:
    """The outer loop (line_search_minimizer.cc:87; line_search.py:291)."""

    def __init__(self, program, options: Options):
        self.program = program
        self.options = options
        self.x_cost = float("nan")

    def _ncg_direction(self, g, prev_grad, prev_direction):
        t = self.options.nonlinear_conjugate_gradient_type
        gg = torch.dot(prev_grad, prev_grad)
        if t == NonlinearConjugateGradientType.FLETCHER_REEVES:
            beta = torch.dot(g, g) / gg
        elif t == NonlinearConjugateGradientType.POLAK_RIBIERE:
            beta = torch.dot(g, g - prev_grad) / gg
        else:  # HESTENES_STIEFEL
            dy = g - prev_grad
            beta = torch.dot(g, dy) / torch.clamp(torch.dot(prev_direction, dy), min=1e-300)
        return -g + torch.clamp(beta, min=0.0) * prev_direction

    def minimize(self, x0: torch.Tensor, summary: Summary) -> torch.Tensor:
        opts, program = self.options, self.program
        start = time.monotonic()
        fetch = _fetcher(summary)
        fn = LineSearchFunction(program, fetch)
        dt = opts.line_search_direction_type
        lbfgs = (LowRankInverseHessian(opts.max_lbfgs_rank,
                                       opts.use_approximate_eigenvalue_bfgs_scaling)
                 if dt == LineSearchDirectionType.LBFGS else None)
        T = program.tangent_size
        bfgs_H, bfgs_init = None, False
        if dt == LineSearchDirectionType.BFGS:
            bfgs_H = torch.eye(T, dtype=torch.float64, device=x0.device)
        search = (WolfeLineSearch(opts) if opts.line_search_type == LineSearchType.WOLFE
                  else ArmijoLineSearch(opts))

        def gmax_of(g):
            return torch.max(torch.abs(g)) if T else torch.zeros((), dtype=g.dtype,
                                                                  device=g.device)

        x = x0
        cost_t, grad = program.evaluate_gradient(x)
        # the first direction is the steepest one
        direction = -grad
        cost, gnorm2, gmax, descent = fetch(cost_t, torch.dot(grad, grad), gmax_of(grad),
                                            torch.dot(direction, grad))
        summary.initial_cost = cost
        self.x_cost = cost
        prev_grad = prev_direction = prev_step = prev_descent = None
        num_restarts = 0
        it_num = 0
        iteration_start = start

        while True:
            it = IterationSummary(iteration=it_num, cost=cost,
                                  gradient_norm=float(np.sqrt(gnorm2)),
                                  gradient_max_norm=gmax, step_is_valid=True,
                                  step_is_successful=True)
            now = time.monotonic()
            it.iteration_time_in_seconds = now - iteration_start
            it.cumulative_time_in_seconds = now - start + summary.preprocessor_time_in_seconds
            it.line_search_function_evaluations = fn.num_value_evals
            summary.iterations.append(it)

            cb = run_callbacks(opts, it, summary, program, x)
            if cb is not None:
                summary.termination_type = cb
                break
            if gmax <= opts.gradient_tolerance:
                summary.message = (f"Gradient tolerance reached. Gradient max norm: "
                                   f"{gmax:e} <= {opts.gradient_tolerance:e}")
                summary.termination_type = TerminationType.CONVERGENCE
                break
            if it_num >= opts.max_num_iterations:
                summary.message = ("Maximum number of iterations reached. Number of "
                                   f"iterations: {it_num}.")
                summary.termination_type = TerminationType.NO_CONVERGENCE
                break
            if (time.monotonic() - start) >= opts.max_solver_time_in_seconds:
                summary.message = "Maximum solver time reached."
                summary.termination_type = TerminationType.NO_CONVERGENCE
                break

            iteration_start = time.monotonic()
            it_num += 1

            # -- the direction, formed and its slope read at the last fetch --
            if descent >= 0:
                num_restarts += 1
                if num_restarts > opts.max_num_line_search_direction_restarts:
                    summary.message = ("Line search direction failure: exceeded "
                                       "max_num_line_search_direction_restarts.")
                    summary.termination_type = TerminationType.NO_CONVERGENCE
                    break
                direction = -grad
                descent = -gnorm2

            # -- the initial step (line_search_minimizer.cc) --------------------
            if it_num == 1:
                step0 = min(1.0, 1.0 / max(gmax, 1e-300))
            elif prev_step is not None and descent != 0.0:
                step0 = min(1.0, 1.05 * prev_step * prev_descent / descent)
            else:
                step0 = 1.0
            step0 = max(step0, opts.min_line_search_step_size)

            fn.init(x, direction)
            result, evals = search.search(fn, step0,
                                          FunctionSample.with_gradient(0.0, cost, descent))
            summary.num_line_search_steps += evals
            if result is None:
                summary.message = ("Numerical failure in line search: failed to find a "
                                   "valid step.")
                summary.termination_type = TerminationType.NO_CONVERGENCE
                break

            # -- the update --------------------------------------------------------
            s_vec = result.x * direction
            new_x = program.plus(x, s_vec)
            new_cost_t, new_grad = program.evaluate_gradient(new_x)
            y_vec = new_grad - grad
            sy_t, yy_t = torch.dot(s_vec, y_vec), torch.dot(y_vec, y_vec)
            # the next directions: with the pair and without it where the
            # pair's test decides (it reads s'y, fetched with them)
            if dt == LineSearchDirectionType.STEEPEST_DESCENT:
                cands = [-new_grad]
            elif dt == LineSearchDirectionType.NONLINEAR_CONJUGATE_GRADIENT:
                cands = [self._ncg_direction(new_grad, grad, direction)]
            elif dt == LineSearchDirectionType.LBFGS:
                pushed = lbfgs.copy()
                pushed.push(s_vec, y_vec, sy_t, yy_t)
                cands = [-pushed.right_multiply(new_grad), -lbfgs.right_multiply(new_grad)]
            else:
                H_pushed = _bfgs_pushed(bfgs_H, bfgs_init, s_vec, y_vec, sy_t, yy_t)
                cands = [-(H_pushed @ new_grad), -(bfgs_H @ new_grad)]
            (new_cost, new_gnorm2, new_gmax, step_norm, x_norm, sy,
             *descents) = fetch(new_cost_t, torch.dot(new_grad, new_grad),
                                gmax_of(new_grad), torch.linalg.vector_norm(s_vec),
                                torch.linalg.vector_norm(new_x), sy_t,
                                *[torch.dot(c, new_grad) for c in cands])
            pick = 0
            if dt == LineSearchDirectionType.LBFGS:
                if sy > _SY_MIN:
                    lbfgs = pushed
                else:
                    pick = 1
            elif dt == LineSearchDirectionType.BFGS:
                if sy > _SY_MIN:
                    bfgs_H, bfgs_init = H_pushed, True
                else:
                    pick = 1
            delta_cost = cost - new_cost

            prev_grad, prev_direction = grad, direction
            prev_step, prev_descent = result.x, descent
            x, cost, grad, gnorm2, gmax = new_x, new_cost, new_grad, new_gnorm2, new_gmax
            direction, descent = cands[pick], descents[pick]
            self.x_cost = cost
            summary.num_successful_steps += 1

            if abs(delta_cost) <= opts.function_tolerance * cost:
                summary.message = (
                    "Function tolerance reached. "
                    f"|cost_change|/cost: {abs(delta_cost) / max(cost, 1e-300):e} <= "
                    f"{opts.function_tolerance:e}")
                summary.termination_type = TerminationType.CONVERGENCE
                break
            if step_norm <= opts.parameter_tolerance * (x_norm + opts.parameter_tolerance):
                summary.message = "Parameter tolerance reached."
                summary.termination_type = TerminationType.CONVERGENCE
                break

        self.x_cost = cost
        return x
