"""Fused trust-region minimizer, Levenberg-Marquardt with the dense-Schur
step (counterpart of ceres_tpu/solvers/fused_lm.py).

The JAX loop runs the whole iteration, evaluate -> LM diagonal -> linear
step -> candidate -> accept/reject -> radius update -> tolerance checks, in
one `lax.while_loop` and fetches to the host once per minimize. Here each
iteration is a short stream of device work that ends in ONE host sync: the
candidate's scalars (step validity, model cost change, cost, step and
state norms, gradient norms) come back as one small tensor, and the host
makes the accept and terminate decisions with the JAX body's arithmetic,
in float64. To keep it at one sync, the candidate's post-evaluation (its
gradient and column norms) runs before the decision, and is dropped if
the step is rejected. Semantics kept from the JAX body: LM diagonal
clamping, model-cost validity, non-monotonic step evaluation, the radius
rules, the invalid-step bound, the gradient/function/parameter/radius
tolerances and the termination taxonomy. Every sync is counted in
`Summary.num_host_syncs`. A loop that stays on the device is ROADMAP.md
port slice 4.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import bsr
from ..ops import flatops as fo
from ..ops import kernels as kn
from ..ops import partition as pt
from ..options import Options
from ..summary import IterationSummary, Summary
from ..types import TerminationType
from .linear.dense import reduced_solve

_DBL_MAX = float(np.finfo(np.float64).max)

_RUNNING = 0
_GRADIENT_TOL = 1
_MIN_RADIUS = 2
_PARAM_TOL = 3
_FUNC_TOL = 4
_INVALID_STEPS = 5
_INIT_FAILURE = 6


class _SEState:
    """TrustRegionStepEvaluator state (trust_region_step_evaluator.{h,cc})."""

    def __init__(self, cost):
        self.minimum = self.current = self.reference = self.candidate = cost
        self.acc_ref = self.acc_cand = 0.0
        self.count = 0

    def quality(self, cost, mcc):
        with np.errstate(all="ignore"):
            rel = (np.float64(self.current) - cost) / np.float64(mcc)
            hist = (np.float64(self.reference) - cost) / (
                np.float64(self.acc_ref) + mcc)
            q = float(np.maximum(rel, hist))
        return -_DBL_MAX if cost >= _DBL_MAX else q

    def accepted(self, cost, mcc, max_steps: int):
        self.current = cost
        acc_cand = self.acc_cand + mcc
        acc_ref = self.acc_ref + mcc
        is_min = cost < self.minimum
        if is_min:
            self.minimum = cost
            self.count = 0
        else:
            self.count += 1
        if is_min or cost > self.candidate:
            self.candidate = cost
            acc_cand = 0.0
        self.acc_cand = acc_cand
        self.acc_ref = acc_ref
        if self.count == max_steps:
            self.reference = self.candidate
            self.acc_ref = self.acc_cand


class JTForm(NamedTuple):
    """Evaluation result in transposed-lane form: jt (24, B) unscaled
    Jacobian lanes, rt (2, B) residual rows, as the kernels take them."""

    jt: torch.Tensor
    rt: torch.Tensor


class DenseSchurStepOps:
    """Exact dense-Schur LM step on the jt-mode kernel path: eliminate the
    points in closed form through per-point K = L^{-1}, assemble the
    reduced camera system with schur_assembly, solve it, back-substitute
    with normal_matvec (fused_lm.py:891-975)."""

    def __init__(self, program, options: Options, e_families):
        self.program = program
        self.pm = pt.build_partition(bsr.build_meta(program), e_families)
        self.flat = fo.FlatSchurOps(self.pm, program)
        self._jt_qual = self.flat.eval_kernel_qual(program)

    def evaluate(self, x):
        """(cost f64 0-d, JTForm) at state x."""
        cost, rt, jt = self.flat.eval_fused_x(self.program, self._jt_qual, x)
        return cost, JTForm(jt=jt, rt=rt)

    def post_eval(self, vrep: JTForm):
        """(gradient J'r, column norms diag(J'J), aux = (E'E blocks,))."""
        g_e, sqn_e, ete, g_f, sqn_f = self.flat.post_eval_kernel_jt(vrep.jt, vrep.rt)
        g = pt.combine(self.pm, g_e, g_f)
        sqn = pt.combine(self.pm, sqn_e, sqn_f)
        return g, sqn, (ete,)

    def _scaled_K(self, ete, se, d2e):
        """Per-point K = L^{-1} of scaled E'E + D_e^2, (P, 9) rows."""
        P, te = self.flat.P, kn.TE
        s = se.reshape(P, te)
        M = ete * (s[:, :, None] * s[:, None, :]).reshape(P, te * te)
        M = M + torch.diag_embed(d2e.reshape(P, te)).reshape(P, te * te)
        return fo.chol_inv_lower_flat(M, te)

    def _kmatvec(self, K, v, transpose=False):
        """Blockwise K v (or K' v) over the point layout."""
        P, te = self.flat.P, kn.TE
        Kb = K.reshape(P, te, te)
        if transpose:
            Kb = Kb.transpose(1, 2)
        return (Kb @ v.reshape(P, te, 1)).reshape(-1)

    def schur_inputs(self, aux, g, scale_c, D2_c):
        """The small operands of the assembly: (b = scale * g, se, sf,
        D_f^2, K (P, 9), u = K b_e)."""
        pm = self.pm
        (ete,) = aux
        se = pt.extract_e(pm, scale_c)
        sf = pt.extract_f(pm, scale_c)
        K = self._scaled_K(ete, se, pt.extract_e(pm, D2_c))
        b = scale_c * g
        u_vec = self._kmatvec(K, pt.extract_e(pm, b))
        return b, se, sf, pt.extract_f(pm, D2_c), K, u_vec

    def compute_step(self, vrep: JTForm, aux, g, scale_c, D2_c):
        """(step, model cost change) of (J_s'J_s + D^2) y = -J_s'r."""
        pm, fl = self.pm, self.flat
        P, C, te, tf = fl.P, fl.C, kn.TE, kn.TF
        b, se, sf, d2f, K, u_vec = self.schur_inputs(aux, g, scale_c, D2_c)
        ata, ftf, U = kn.schur_assembly(
            vrep.jt, sf.reshape(C, tf), se.reshape(P, te), K,
            u_vec.reshape(P, te), fl.plan)
        eye = torch.eye(C, dtype=ata.dtype, device=ata.device)
        S = torch.einsum("cij,cd->cidj", ftf.reshape(C, tf, tf), eye).reshape(
            C * tf, C * tf)
        S = S - ata + torch.diag(d2f)
        rhs = pt.extract_f(pm, b) - U
        z = reduced_solve(S, rhs)
        # implicit back substitution: y_e = K'(u - K E_s'F_s z)
        normal = fl.make_kernel_suite_raw(vrep.jt, se, sf)
        _, ptv = normal(z, torch.zeros((P, te), dtype=z.dtype, device=z.device))
        Az = self._kmatvec(K, ptv.reshape(-1))
        y_e = self._kmatvec(K, u_vec - Az, transpose=True)
        step = -pt.combine(pm, y_e, z)
        # exact-solve identity: -m(d) = -1/2 g_s'd + 1/2 d'D^2 d
        g_dot = torch.dot(b, step)
        d2_dot = torch.dot(D2_c * step, step)
        return step, -0.5 * g_dot + 0.5 * d2_dot


def _grad_norms(x, g):
    """|x - Plus(x, -g)| and its max norm (Euclidean Plus)."""
    dx = x - (x + (-g.to(torch.float64)))
    if dx.numel() == 0:
        z = torch.zeros((), dtype=torch.float64, device=x.device)
        return z, z
    return torch.linalg.vector_norm(dx), torch.max(torch.abs(dx))


class FusedTrustRegionMinimizer:
    """LM over a step adapter with one host sync per iteration."""

    def __init__(self, program, options: Options, ops):
        self.program = program
        self.options = options
        self.ops = ops
        self.x_cost = float("nan")

    def _fetch(self, summary: Summary, *scalars):
        summary.num_host_syncs += 1
        return torch.stack([s.to(torch.float64).reshape(()) for s in scalars]).tolist()

    def minimize(self, x0: torch.Tensor, summary: Summary) -> torch.Tensor:
        opts, ops = self.options, self.ops
        cdt = self.program.compute_dtype
        max_iters = int(opts.max_num_iterations)
        min_d, max_d = opts.min_lm_diagonal, opts.max_lm_diagonal
        max_steps = (opts.max_consecutive_nonmonotonic_steps
                     if opts.use_nonmonotonic_steps else 0)

        cost_t, vrep = ops.evaluate(x0)
        g, sqn_c, aux = ops.post_eval(vrep)
        sqn = sqn_c.to(torch.float64)
        if opts.jacobi_scaling:
            scale = 1.0 / (1.0 + torch.sqrt(sqn))
        else:
            scale = torch.ones_like(sqn)
        scale_c = scale.to(cdt)
        gnorm_t, gmax_t = _grad_norms(x0, g)
        cost, gnorm, gmax = self._fetch(summary, cost_t, gnorm_t, gmax_t)

        radius = float(opts.initial_trust_region_radius)
        if not np.isfinite(cost):
            term = _INIT_FAILURE
        elif gmax <= opts.gradient_tolerance:
            term = _GRADIENT_TOL
        elif radius <= opts.min_trust_region_radius:
            term = _MIN_RADIUS
        else:
            term = _RUNNING
        rows = [IterationSummary(
            iteration=0, cost=cost, gradient_norm=gnorm, gradient_max_norm=gmax,
            trust_region_radius=radius, step_is_valid=True,
            step_is_successful=True, linear_solver_iterations=0)]
        x = x0
        decrease_factor = 2.0
        se = _SEState(cost)
        num_invalid = 0
        any_success = False
        min_cost, best_x = cost, x0
        it = 0

        while term == _RUNNING and it < max_iters:
            it += 1
            # -- LM step (levenberg_marquardt_strategy.cc:69-120) -----------
            diag = torch.clamp(scale * scale * sqn, min_d, max_d)
            D2_c = (diag / radius).to(cdt)
            step, mcc_c = ops.compute_step(vrep, aux, g, scale_c, D2_c)
            mcc_t = mcc_c.to(torch.float64)
            valid_t = torch.isfinite(step).all() & (mcc_t > 0.0)
            cand_x = x + step.to(torch.float64) * scale
            cand_cost_t, cand_vrep = ops.evaluate(cand_x)
            cand_g, cand_sqn, cand_aux = ops.post_eval(cand_vrep)
            cgnorm_t, cgmax_t = _grad_norms(cand_x, cand_g)
            (valid_f, mcc, cand_cost, step_norm, x_norm, cgnorm,
             cgmax) = self._fetch(
                summary, valid_t, mcc_t, cand_cost_t,
                torch.linalg.vector_norm(x - cand_x),
                torch.linalg.vector_norm(x), cgnorm_t, cgmax_t)
            valid = valid_f != 0.0
            if not np.isfinite(cand_cost):
                cand_cost = _DBL_MAX

            # -- invalid steps (trust_region_minimizer.cc:467) --------------
            num_invalid = 0 if valid else num_invalid + 1
            if not valid and num_invalid >= opts.max_num_consecutive_invalid_steps:
                term = _INVALID_STEPS

            # -- tolerances ---------------------------------------------------
            ptol = opts.parameter_tolerance
            param_hit = valid and any_success and step_norm <= ptol * (x_norm + ptol)
            cost_change = cost - cand_cost
            func_hit = (valid and not param_hit
                        and abs(cost_change) <= opts.function_tolerance * cost)
            if param_hit:
                term = _PARAM_TOL
            elif func_hit:
                term = _FUNC_TOL
            breaking = term != _RUNNING

            # -- accept / reject --------------------------------------------
            rel_dec = se.quality(cand_cost, mcc)
            success = valid and not breaking and rel_dec > opts.min_relative_decrease
            if success:
                old_min = min_cost
                x, cost, vrep = cand_x, cand_cost, cand_vrep
                g, aux, sqn = cand_g, cand_aux, cand_sqn.to(torch.float64)
                gnorm, gmax = cgnorm, cgmax
                se.accepted(cand_cost, mcc, max_steps)
                if cand_cost < old_min:
                    min_cost = cand_cost
                if cand_cost <= old_min:
                    best_x = cand_x

            # -- radius update -----------------------------------------------
            if breaking:
                radius_new = radius
                decrease_new = decrease_factor
            elif success:
                radius_new = min(
                    radius / max(1.0 / 3.0, 1.0 - (2.0 * rel_dec - 1.0) ** 3),
                    opts.max_trust_region_radius)
                decrease_new = 2.0
            else:
                radius_new = radius / decrease_factor
                decrease_new = decrease_factor * 2.0
            if term == _RUNNING and success and gmax <= opts.gradient_tolerance:
                term = _GRADIENT_TOL
            if term == _RUNNING and radius_new <= opts.min_trust_region_radius:
                term = _MIN_RADIUS

            rows.append(IterationSummary(
                iteration=it,
                cost=cost if (success or not valid) else cand_cost,
                cost_change=cost_change if valid else 0.0,
                gradient_norm=gnorm, gradient_max_norm=gmax,
                step_norm=step_norm if valid else 0.0,
                relative_decrease=rel_dec if valid else 0.0,
                trust_region_radius=radius_new, linear_solver_iterations=1,
                step_is_valid=valid, step_is_successful=success))
            radius, decrease_factor = radius_new, decrease_new
            any_success = any_success or success

        x_final = best_x if cost > min_cost else x
        self.x_cost = min(cost, min_cost)
        self._summarize(summary, rows, it, term)
        return x_final

    def _summarize(self, summary: Summary, rows, n_it: int, term: int):
        opts = self.options
        summary.initial_cost = rows[0].cost
        for i, row in enumerate(rows):
            summary.iterations.append(row)
            # rows that broke the loop mid-iteration are not counted
            if i == n_it and term in (_PARAM_TOL, _FUNC_TOL, _INVALID_STEPS):
                continue
            if row.step_is_successful:
                summary.num_successful_steps += 1
            else:
                summary.num_unsuccessful_steps += 1
        summary.num_linear_solves = n_it
        summary.num_jacobian_evaluations += n_it + 1
        summary.num_residual_evaluations += n_it + 1
        last = rows[n_it]
        if term == _INIT_FAILURE:
            summary.message = "Initial residual and Jacobian evaluation failed."
            summary.termination_type = TerminationType.FAILURE
        elif term == _GRADIENT_TOL:
            summary.message = (
                "Gradient tolerance reached. Gradient max norm: "
                f"{last.gradient_max_norm:e} <= {opts.gradient_tolerance:e}")
            summary.termination_type = TerminationType.CONVERGENCE
        elif term == _MIN_RADIUS:
            summary.message = (
                "Minimum trust region radius reached. Trust region radius: "
                f"{last.trust_region_radius:e} <= {opts.min_trust_region_radius:e}")
            summary.termination_type = TerminationType.CONVERGENCE
        elif term == _PARAM_TOL:
            summary.message = (
                "Parameter tolerance reached. Relative step_norm: "
                f"{last.step_norm:e} <= {opts.parameter_tolerance:e}.")
            summary.termination_type = TerminationType.CONVERGENCE
        elif term == _FUNC_TOL:
            summary.message = (
                "Function tolerance reached. |cost_change|/cost: "
                f"{abs(last.cost_change) / max(last.cost, 1e-300):e}"
                f" <= {opts.function_tolerance:e}")
            summary.termination_type = TerminationType.CONVERGENCE
        elif term == _INVALID_STEPS:
            summary.message = (
                "Number of consecutive invalid steps more than "
                "Solver::Options::max_num_consecutive_invalid_steps: "
                f"{opts.max_num_consecutive_invalid_steps}")
            summary.termination_type = TerminationType.FAILURE
        else:
            summary.message = (
                f"Maximum number of iterations reached. Number of iterations: {n_it}.")
            summary.termination_type = TerminationType.NO_CONVERGENCE


def build_fused_minimizer(program, options: Options, tier: str, e_families=None):
    """Factory for the fused minimizer of a linear-solver tier; the slice
    has the dense-Schur tier only."""
    if tier != "schur_dense":
        raise NotImplementedError(f"fused tier {tier!r} is not ported")
    ops = DenseSchurStepOps(program, options, e_families)
    return FusedTrustRegionMinimizer(program, options, ops)
