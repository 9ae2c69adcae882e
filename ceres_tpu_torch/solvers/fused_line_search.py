"""The fused line-search minimizer (counterpart of
ceres_tpu/solvers/fused_line_search.py): LBFGS, BFGS, nonlinear
conjugate gradients or steepest descent with the Armijo or strong-Wolfe
search, in the JAX fused loop's arithmetic.

The JAX package runs the whole loop in one `lax.while_loop`. Here, as in
the port's fused LM loop (solvers/fused_lm.py), the state stays on the
device (the iterate, the gradient, the direction, the fixed (max_lbfgs_rank,
T) curvature buffers with their count, the dense BFGS matrix) and the
host makes the loop's decisions on float64 scalars. Each probe of a
search evaluates the cost and the full gradient and costs one host sync,
which brings back its value, slope and validity; the accepted probe's
gradient is the next iteration's, so there is no evaluation after the
search. Each iteration adds one sync: the step and state norms and the
new gradient's norms, with the slope of the next direction, formed on the
device before the host has decided to go on. The curvature pair's test
(s'y > 1e-10) is made on the device, as the JAX loop makes it. Probes
the JAX loop evaluates and then discards (its traced body evaluates both
phases of the Wolfe search, and the probe after a failed Armijo test)
are not run here; the evaluation counts are the JAX loop's.

What differs from the host loop (solvers/line_search.py), as in the JAX
package: the Armijo interpolation fits the reference's {initial, current,
previous} window and minimizes it by a 33-point grid and four Newton
steps (`_min_poly`, `_interp_minimum3`); the Wolfe zoom interpolates
between its two ends inside a 1% margin; the Armijo test reads the
current probe's slope. Every quantity is computed in float64 whatever
the evaluation dtype. Every sync is counted in `Summary.num_host_syncs`.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..options import Options
from ..summary import IterationSummary, Summary
from ..types import (
    LineSearchDirectionType,
    LineSearchInterpolationType,
    LineSearchType,
    NonlinearConjugateGradientType,
    TerminationType,
)

_RUNNING = 0
_GRADIENT_TOL = 1
_PARAM_TOL = 3
_FUNC_TOL = 4
_LS_FAIL = 7
_RESTARTS = 8

f64 = np.float64


@dataclasses.dataclass
class _Sample:
    """A probe's step s, value f, slope dphi and validity (host floats)."""

    s: float
    f: float
    dphi: float
    valid: bool


def _clip(x, lo, hi):
    return min(max(x, lo), hi)  # jnp.clip


def _interp_minimum(interp, s0: _Sample, s1: _Sample, lower, upper):
    """The minimizer of the interpolant through s0 (value and slope) and
    s1, clipped to [lower, upper]; half the larger step where the closed
    form is undefined or s1 invalid, which is also BISECTION
    (fused_line_search.py:74-100)."""
    half = _clip(f64(0.5) * max(f64(s0.s), f64(s1.s)), lower, upper)
    if interp == LineSearchInterpolationType.BISECTION:
        return half
    x0, f0, g0 = f64(s0.s), f64(s0.f), f64(s0.dphi)
    x1, f1, g1 = f64(s1.s), f64(s1.f), f64(s1.dphi)
    dx = x1 - x0
    with np.errstate(all="ignore"):
        if interp == LineSearchInterpolationType.QUADRATIC:
            denom = 2.0 * (f1 - f0 - g0 * dx)
            cand = x0 - g0 * dx * dx / denom
            ok = np.isfinite(cand) and abs(denom) > 0.0
        else:  # CUBIC
            d1 = g0 + g1 - 3.0 * (f0 - f1) / (f64(1.0) if dx == 0.0 else -dx)
            disc = d1 * d1 - g0 * g1
            d2 = np.sign(dx) * np.sqrt(max(disc, f64(0.0)))
            denom = g1 - g0 + 2.0 * d2
            cand = x1 - dx * (g1 + d2 - d1) / (f64(1.0) if denom == 0.0 else denom)
            ok = disc >= 0.0 and denom != 0.0 and np.isfinite(cand)
    ok = ok and s1.valid and np.isfinite(f1)
    return _clip(cand, lower, upper) if ok else half


def _min_poly(coeffs, lower, upper, sample_xs):
    """The least value of the polynomial on [lower, upper]: the best of a
    33-point grid polished by four Newton steps on p', the interval's ends
    and the samples (fused_line_search.py:103-126)."""
    d1 = np.polyder(coeffs)
    d2 = np.polyder(d1)
    xs = lower + (upper - lower) * np.linspace(0.0, 1.0, 33)
    with np.errstate(all="ignore"):
        x = xs[np.argmin(np.polyval(coeffs, xs))]
        for _ in range(4):
            p1, p2 = np.polyval(d1, x), np.polyval(d2, x)
            x = _clip(x - p1 / p2 if abs(p2) > 0.0 else x, lower, upper)
        cands = np.concatenate([[x, lower, upper],
                                np.minimum(np.maximum(sample_xs, lower), upper)])
        vals = np.polyval(coeffs, cands)
    vals = np.where(np.isfinite(vals), vals, np.inf)
    return cands[np.argmin(vals)]


def _interp_minimum3(interp, s0: _Sample, s_prev: _Sample, s_cur: _Sample, lower, upper):
    """The Armijo step: the polynomial through {initial (value and slope),
    current, previous if valid}, values only for the last two under
    QUADRATIC, minimized on [lower, upper]; the two-point form where
    previous is invalid or the fit degenerates
    (fused_line_search.py:129-171)."""
    two_pt = _interp_minimum(interp, s0, s_cur, lower, upper)
    if interp == LineSearchInterpolationType.BISECTION or not s_prev.valid:
        return two_pt
    xs = [f64(s0.s), f64(s_cur.s), f64(s_prev.s)]
    fs = [f64(s0.f), f64(s_cur.f), f64(s_prev.f)]
    gs = [f64(s0.dphi), f64(s_cur.dphi), f64(s_prev.dphi)]
    use = ([True, False, False] if interp == LineSearchInterpolationType.QUADRATIC
           else [True, True, True])
    n = 3 + sum(use)
    deg = n - 1
    A = [[x ** (deg - j) for j in range(n)] for x in xs]
    b = list(fs)
    for x, g, u in zip(xs, gs, use):
        if u:
            A.append([(deg - j) * x ** max(deg - j - 1, 0) if j < deg else f64(0.0)
                      for j in range(n)])
            b.append(g)
    try:
        with np.errstate(all="ignore"):
            coeffs = np.linalg.solve(np.asarray(A, f64), np.asarray(b, f64))
    except np.linalg.LinAlgError:
        return two_pt
    if not np.all(np.isfinite(coeffs)):
        return two_pt
    three_pt = _min_poly(coeffs, lower, upper, np.asarray(xs))
    return three_pt if np.isfinite(three_pt) else two_pt


class FusedLineSearchMinimizer:
    """The fused loop over a program: its state on the device, a host sync
    per probe and per iteration."""

    def __init__(self, program, options: Options):
        self.program = program
        self.options = options
        self.x_cost = float("nan")

    # -- the device evaluation -------------------------------------------------

    def _fetch(self, *scalars):
        self._summary.num_host_syncs += 1
        return torch.stack([torch.as_tensor(s).to(torch.float64).reshape(())
                            for s in scalars]).tolist()

    def _probe(self, x, d, s: float):
        """phi(s), phi'(s) and validity at x [+] s d (one sync), and the
        full gradient there (on the device)."""
        cost, grad = self.program.evaluate_gradient(self.program.plus(x, s * d))
        valid = torch.isfinite(cost) & torch.isfinite(grad).all()
        f, dphi, v = self._fetch(cost, torch.dot(grad, d), valid)
        return _Sample(s=s, f=f, dphi=dphi, valid=v != 0.0), grad

    # -- the searches ------------------------------------------------------------

    def _armijo(self, x, d, step0, f0, dphi0, g0):
        """Backtracking with interpolation (fused_line_search.py:204-256):
        (ok, sample, gradient, evaluations)."""
        o = self.options
        c1 = o.line_search_sufficient_function_decrease
        max_it = int(o.max_num_line_search_step_size_iterations)
        initial = _Sample(0.0, f0, dphi0, True)
        prev = _Sample(0.0, np.inf, 0.0, False)
        cur, grad = self._probe(x, d, step0)

        def needs_backtrack(c):
            return (not c.valid) or c.f > f0 + c1 * c.s * c.dphi

        i, fail = 0, False
        while not fail and needs_backtrack(cur):
            i += 1
            fail = i >= max_it
            lower = o.max_line_search_step_contraction * cur.s
            upper = o.min_line_search_step_contraction * cur.s
            new_s = _interp_minimum3(o.line_search_interpolation_type, initial, prev, cur,
                                     lower, upper)
            fail = fail or new_s < o.min_line_search_step_size
            if not fail:
                nxt, ngrad = self._probe(x, d, float(max(new_s, 0.0)))
                prev, cur, grad = cur, nxt, ngrad
        return (not fail) and not needs_backtrack(cur), cur, grad, i + 1

    def _wolfe(self, x, d, step0, f0, dphi0, g0):
        """Bracketing, then zoom, as the JAX loop's phases
        (fused_line_search.py:258-417): (ok, sample, gradient, evaluations)."""
        o = self.options
        c1 = o.line_search_sufficient_function_decrease
        c2 = o.line_search_sufficient_curvature_decrease
        max_evals = int(o.max_num_line_search_step_size_iterations)
        interp = o.line_search_interpolation_type
        initial = _Sample(0.0, f0, dphi0, True)
        cur, cur_g = self._probe(x, d, step0)
        is_first = True
        prev, prev_g = initial, g0
        lo, lo_g, hi, hi_grad_ok = initial, g0, initial, True
        evals, ok = 1, False
        while True:
            # -- bracketing ---------------------------------------------------
            fails_armijo = ((not cur.valid) or cur.f > f0 + c1 * cur.s * dphi0
                            or (not is_first and cur.f >= prev.f))
            curvature_ok = not fails_armijo and abs(cur.dphi) <= c2 * abs(dphi0)
            derivative_up = not fails_armijo and not curvature_ok and cur.dphi >= 0.0
            if curvature_ok or not (fails_armijo or derivative_up) and evals >= max_evals:
                return curvature_ok or cur.valid, cur, cur_g, evals
            if fails_armijo or derivative_up:
                if fails_armijo:
                    lo, lo_g, hi = prev, prev_g, cur
                else:
                    lo, lo_g, hi = cur, cur_g, prev
                hi_grad_ok = True
                break
            ncur, ncur_g = self._probe(x, d, cur.s * o.max_line_search_step_expansion)
            is_first = False
            prev, prev_g, cur, cur_g = cur, cur_g, ncur, ncur_g
            evals += 1

        while True:
            # -- zoom -----------------------------------------------------------
            lower, upper = min(lo.s, hi.s), max(lo.s, hi.s)
            if upper - lower < o.min_line_search_step_size or evals >= max_evals:
                return lo.valid and lo.s > 0.0, lo, lo_g, evals
            margin = 0.01 * (upper - lower)
            hi_interp = _Sample(hi.s, hi.f, hi.dphi if hi_grad_ok else 0.0,
                                hi.valid and np.isfinite(hi.f) and hi_grad_ok)
            new_s = float(_interp_minimum(interp, lo, hi_interp, lower + margin,
                                          upper - margin))
            trial, trial_g = self._probe(x, d, new_s)
            evals += 1
            if not trial.valid:
                hi, hi_grad_ok = _Sample(new_s, np.inf, 0.0, True), False
                continue
            shrinks_hi = trial.f > f0 + c1 * trial.s * dphi0 or trial.f >= lo.f
            if not shrinks_hi and abs(trial.dphi) <= c2 * abs(dphi0):
                return True, trial, trial_g, evals
            if shrinks_hi:
                hi, hi_grad_ok = trial, True
            else:
                if trial.dphi * (hi.s - lo.s) >= 0.0:
                    hi, hi_grad_ok = lo, True
                lo, lo_g = trial, trial_g

    # -- the loop -----------------------------------------------------------------

    def minimize(self, x0: torch.Tensor, summary: Summary) -> torch.Tensor:
        opts, prog = self.options, self.program
        self._summary = summary
        t0 = time.monotonic()
        T = prog.tangent_size
        dev = x0.device
        max_iters = int(opts.max_num_iterations)
        dt = opts.line_search_direction_type
        search = self._wolfe if opts.line_search_type == LineSearchType.WOLFE else self._armijo
        m = int(opts.max_lbfgs_rank) if dt == LineSearchDirectionType.LBFGS else 1
        use_bfgs = dt == LineSearchDirectionType.BFGS
        z64 = dict(dtype=torch.float64, device=dev)

        def gmax_of(g):
            return torch.max(torch.abs(g)) if T else torch.zeros((), **z64)

        x = x0.to(torch.float64)
        cost_t, grad = prog.evaluate_gradient(x)
        gnorm2_t = torch.dot(grad, grad)
        S, Y = torch.zeros((m, T), **z64), torch.zeros((m, T), **z64)
        rho, cnt = torch.zeros((m,), **z64), torch.zeros((), dtype=torch.int64, device=dev)
        hscale = torch.ones((), **z64)
        Tb = T if use_bfgs else 1
        bfgs_H = torch.eye(Tb, **z64)
        bfgs_init = torch.zeros((), dtype=torch.bool, device=dev)
        have_prev = False
        prev_grad = prev_dir = torch.zeros((T,), **z64)

        def lbfgs_apply(g):
            """The two-loop recursion over the fixed buffers, entries past
            the count masked (fused_line_search.py:495-516)."""
            q = g
            alphas = [None] * m
            for j in reversed(range(m)):
                a = torch.where(j < cnt, rho[j] * torch.dot(S[j], q), 0.0)
                alphas[j] = a
                q = q - a * Y[j]
            if opts.use_approximate_eigenvalue_bfgs_scaling:
                q = q * hscale
            else:
                q = torch.where(cnt > 0, q * hscale, q)
            for j in range(m):
                b = torch.where(j < cnt, rho[j] * torch.dot(Y[j], q), 0.0)
                q = q + (alphas[j] - b) * S[j]
            return q

        def direction_of(g, gnorm2):
            """The direction from the state (fused_line_search.py:522-546)."""
            if dt == LineSearchDirectionType.STEEPEST_DESCENT or not have_prev:
                return -g
            if dt == LineSearchDirectionType.NONLINEAR_CONJUGATE_GRADIENT:
                t = opts.nonlinear_conjugate_gradient_type
                gg_prev = torch.dot(prev_grad, prev_grad)
                safe = torch.where(gg_prev == 0.0, 1.0, gg_prev)
                if t == NonlinearConjugateGradientType.FLETCHER_REEVES:
                    beta = gnorm2 / safe
                elif t == NonlinearConjugateGradientType.POLAK_RIBIERE:
                    beta = torch.dot(g, g - prev_grad) / safe
                else:  # HESTENES_STIEFEL
                    dy = g - prev_grad
                    dd = torch.dot(prev_dir, dy)
                    beta = torch.dot(g, dy) / torch.where(torch.abs(dd) < 1e-300, 1e-300, dd)
                return -g + torch.clamp(beta, min=0.0) * prev_dir
            if dt == LineSearchDirectionType.LBFGS:
                return -lbfgs_apply(g)
            return -(bfgs_H @ g)

        direction = direction_of(grad, gnorm2_t)
        cost, gnorm2, gmax, descent = self._fetch(cost_t, gnorm2_t, gmax_of(grad),
                                                  torch.dot(direction, grad))
        term = _GRADIENT_TOL if gmax <= opts.gradient_tolerance else _RUNNING
        h_cost, h_gnorm, h_gmax = [cost], [float(np.sqrt(gnorm2))], [gmax]
        h_step, h_evals = [0.0], [0]
        restarts, it, evals_total = 0, 0, 1
        prev_step = prev_descent = 0.0

        while term == _RUNNING and it < max_iters:
            it += 1
            g = grad
            # -- restarts and the initial step --------------------------------
            needs_restart = descent >= 0.0
            restarts += int(needs_restart)
            restart_fail = needs_restart and restarts > opts.max_num_line_search_direction_restarts
            if needs_restart:
                direction, descent = -g, -gnorm2
            if not have_prev:
                step0 = min(1.0, 1.0 / max(gmax, 1e-300))
            elif descent != 0.0:
                step0 = min(1.0, 1.05 * prev_step * prev_descent / descent)
            else:
                step0 = 1.0
            step0 = max(step0, opts.min_line_search_step_size)

            ok, res, res_g, evals = search(x, direction, step0, cost, descent, g)
            ok = ok and not restart_fail
            evals_total += evals

            term = _RESTARTS if restart_fail else (_RUNNING if ok else _LS_FAIL)
            if not ok:
                h_cost.append(cost)
                h_gnorm.append(float(np.sqrt(gnorm2)))
                h_gmax.append(h_gmax[-1])
                h_step.append(0.0)
                h_evals.append(evals_total)
                continue

            # -- the update (fused_line_search.py:576-621) --------------------
            step_vec = res.s * direction
            new_x = prog.plus(x, step_vec)
            new_cost, new_grad = res.f, res_g
            dg = new_grad - g
            sy = torch.dot(step_vec, dg)
            push = sy > 1e-10
            if dt == LineSearchDirectionType.LBFGS:
                full = cnt == m
                Sb = torch.where(full, torch.roll(S, -1, 0), S)
                Yb = torch.where(full, torch.roll(Y, -1, 0), Y)
                rb = torch.where(full, torch.roll(rho, -1), rho)
                idx = torch.clamp(cnt, max=m - 1).reshape(1)
                Sb = Sb.index_copy(0, idx, step_vec[None])
                Yb = Yb.index_copy(0, idx, dg[None])
                rb = rb.index_copy(0, idx, (1.0 / torch.where(sy == 0.0, 1.0, sy)).reshape(1))
                S, Y = torch.where(push, Sb, S), torch.where(push, Yb, Y)
                rho = torch.where(push, rb, rho)
                cnt = torch.where(push, torch.clamp(cnt + 1, max=m), cnt)
                hscale = torch.where(push, sy / torch.clamp(torch.dot(dg, dg), min=1e-300),
                                     hscale)
            if use_bfgs:
                scale0 = sy / torch.clamp(torch.dot(dg, dg), min=1e-300)
                Hb = torch.where(push & ~bfgs_init, bfgs_H * scale0, bfgs_H)
                rho_b = 1.0 / torch.where(sy == 0.0, 1.0, sy)
                V = torch.eye(T, **z64) - rho_b * torch.outer(step_vec, dg)
                bfgs_H = torch.where(push, V @ Hb @ V.T + rho_b * torch.outer(step_vec, step_vec),
                                     bfgs_H)
                bfgs_init = bfgs_init | push
            delta_cost = cost - new_cost
            prev_grad, prev_dir = g, direction
            prev_step, prev_descent, have_prev = res.s, descent, True
            x, grad = new_x, new_grad
            new_gnorm2_t = torch.dot(new_grad, new_grad)

            # -- the tolerances (fused_line_search.py:624-648) ------------------
            func_hit = abs(delta_cost) <= opts.function_tolerance * max(new_cost, 1e-300)
            extra = ()
            if not func_hit and it < max_iters:
                # the next direction, read with this iteration's norms
                direction = direction_of(new_grad, new_gnorm2_t)
                extra = (torch.dot(direction, new_grad),)
            step_norm, x_norm, new_gmax, new_gnorm2, *next_descent = self._fetch(
                torch.linalg.vector_norm(step_vec), torch.linalg.vector_norm(new_x),
                gmax_of(new_grad), new_gnorm2_t, *extra)
            ptol = opts.parameter_tolerance
            param_hit = not func_hit and step_norm <= ptol * (x_norm + ptol)
            grad_hit = not func_hit and not param_hit and new_gmax <= opts.gradient_tolerance
            term = (_FUNC_TOL if func_hit else _PARAM_TOL if param_hit
                    else _GRADIENT_TOL if grad_hit else _RUNNING)
            cost, gnorm2, gmax = new_cost, new_gnorm2, new_gmax
            descent = next_descent[0] if next_descent else 0.0
            h_cost.append(cost)
            h_gnorm.append(float(np.sqrt(gnorm2)))
            h_gmax.append(gmax)
            h_step.append(step_norm)
            h_evals.append(evals_total)

        self.x_cost = cost
        self._summarize(summary, h_cost, h_gnorm, h_gmax, h_step, h_evals, it, term)
        summary.minimizer_time_in_seconds = time.monotonic() - t0
        return x

    def _summarize(self, summary, h_cost, h_gnorm, h_gmax, h_step, h_evals, n_it, term):
        """The rows and the termination, as the JAX wrapper decodes them
        (fused_line_search.py:698-771)."""
        opts = self.options
        summary.initial_cost = h_cost[0]
        # the host loop appends a row per loop-top visit: no row for a
        # mid-iteration break (a tolerance, a search failure)
        last_row = n_it
        if term in (_FUNC_TOL, _PARAM_TOL, _LS_FAIL, _RESTARTS):
            last_row = max(0, n_it - 1)
        for i in range(last_row + 1):
            summary.iterations.append(IterationSummary(
                iteration=i, cost=h_cost[i], gradient_norm=h_gnorm[i],
                gradient_max_norm=h_gmax[i], step_norm=h_step[i], step_is_valid=True,
                step_is_successful=True, line_search_function_evaluations=h_evals[i]))
        fail_steps = 1 if term in (_LS_FAIL, _RESTARTS) else 0
        summary.num_successful_steps += max(0, n_it - fail_steps)
        summary.num_line_search_steps += h_evals[n_it]
        summary.num_residual_evaluations += h_evals[n_it] + 1
        summary.num_gradient_evaluations += h_evals[n_it] + 1
        if term == _GRADIENT_TOL:
            summary.message = ("Gradient tolerance reached. Gradient max norm: "
                               f"{h_gmax[n_it]:e} <= {opts.gradient_tolerance:e}")
            summary.termination_type = TerminationType.CONVERGENCE
        elif term == _FUNC_TOL:
            summary.message = ("Function tolerance reached. |cost_change|/cost <= "
                               f"{opts.function_tolerance:e}")
            summary.termination_type = TerminationType.CONVERGENCE
        elif term == _PARAM_TOL:
            summary.message = "Parameter tolerance reached."
            summary.termination_type = TerminationType.CONVERGENCE
        elif term == _LS_FAIL:
            summary.message = "Numerical failure in line search: failed to find a valid step."
            summary.termination_type = TerminationType.NO_CONVERGENCE
        elif term == _RESTARTS:
            summary.message = ("Line search direction failure: exceeded "
                               "max_num_line_search_direction_restarts.")
            summary.termination_type = TerminationType.NO_CONVERGENCE
        else:
            summary.message = ("Maximum number of iterations reached. "
                               f"Number of iterations: {n_it}.")
            summary.termination_type = TerminationType.NO_CONVERGENCE


def build_fused_line_search(program, options: Options):
    """The fused loop where the JAX gate takes it, else None for the host
    loop (fused_line_search.py:774-801): fused_loop NEVER, AUTO below
    fused_loop_min_residuals (a GradientProblem has none), callbacks,
    update_state_every_iteration, an evaluation callback or a finite solve
    time. The minimizer is reused across solves of one program by options;
    it keeps no state between solves."""
    mode = options.fused_loop.upper()
    if mode == "NEVER":
        return None
    if mode == "AUTO" and getattr(program, "num_residuals", 0) < options.fused_loop_min_residuals:
        return None
    if (options.callbacks or options.update_state_every_iteration
            or options.evaluation_callback is not None
            or options.max_solver_time_in_seconds < 1e6):
        return None
    key = ("line_search", options.fingerprint())
    m = program._minimizer_cache.get(key)
    if m is None:
        m = program._minimizer_cache[key] = FusedLineSearchMinimizer(program, options)
    return m
