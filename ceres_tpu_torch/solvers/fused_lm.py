"""Fused trust-region minimizer, Levenberg-Marquardt or dogleg, over the
step adapters of each linear solver (counterpart of
ceres_tpu/solvers/fused_lm.py).

The Schur steps have two forms each, as the JAX classes do: the jt form
(`DenseSchurStepOps`, `IterativeSchurStepOps`) for the programs the fused
jt-mode kernels take (BAL), and the flat form (`FlatDenseSchurStepOps`,
`FlatIterativeSchurStepOps`) for every other program (the libmv bundle
adjuster) and for the power series and cluster preconditioners: a plain
evaluation, flattened Jacobian blocks and the flat products of
ops/flatops.FlatSchurOps. `ExplicitSchurStepOps` runs CG over the dense S
of the flat dense-Schur step (use_explicit_schur_complement).
`CgnrStepOps` runs CGNR over the flat products of the whole Jacobian
(ops/flatops.FlatJacobianOps), its
matvec through normal_matvec on a BAL-shaped program; `DenseStepOps` runs
DENSE_QR and DENSE_NORMAL_CHOLESKY on the dense Jacobian; `DoglegStepOps`
runs TRADITIONAL and SUBSPACE dogleg over an exact step.
`build_fused_minimizer` routes by tier, strategy and `flatops.jt_refusal`.

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
rules (the dogleg ones and its mu under DOGLEG), the invalid-step bound,
the gradient/function/parameter/radius tolerances and the termination
taxonomy. A bounded program starts from x0 projected onto its box, masks
the Jacobi scale of the coordinates held on a bound (the active set), and
backtracks each step by a projected Armijo line search on cost-only
evaluations (fused_lm.py:1358-1378, :1494-1528). The iterative steps
(ITERATIVE_SCHUR, CGNR) add one sync per CG iteration
(solvers/linear/cg.py), dogleg one per test of its Gauss-Newton point, the
line search one per probe. Every sync is counted in
`Summary.num_host_syncs`. A loop that
stays on the device is ROADMAP.md port slice 4.
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
from ..types import (
    DoglegType,
    PreconditionerType,
    TerminationType,
    TrustRegionStrategyType,
)
from .linear.cg import conjugate_gradients
from .linear.dense import (normal_cholesky_solve, normal_cholesky_solve_mixed,
                           qr_solve, reduced_solve)
from .trust_region import TrustRegionStepEvaluator, active_set_mask, grad_norms

_DBL_MAX = float(np.finfo(np.float64).max)

_RUNNING = 0
_GRADIENT_TOL = 1
_MIN_RADIUS = 2
_PARAM_TOL = 3
_FUNC_TOL = 4
_INVALID_STEPS = 5
_INIT_FAILURE = 6


class JTForm(NamedTuple):
    """Evaluation result in transposed-lane form: jt (24, B) unscaled
    Jacobian lanes, rt (2, B) residual rows, as the kernels take them."""

    jt: torch.Tensor
    rt: torch.Tensor


class FlatForm(NamedTuple):
    """Evaluation result on the flat path: vflat[k][s] (B, r*t) Jacobian
    blocks of each kind and slot, r (N,) the residuals of every kind."""

    vflat: tuple
    r: torch.Tensor


class DenseForm(NamedTuple):
    """Evaluation result of the dense solvers: J (N, tangent) float64, as
    the JAX package assembles it, r (N,) the residuals."""

    J: torch.Tensor
    r: torch.Tensor


class CgnrForm(NamedTuple):
    """Evaluation result of the CGNR step: the flat blocks and residuals
    of FlatForm, and JT (24, B), the lanes normal_matvec reads, on a
    program it takes (else None)."""

    vflat: tuple
    r: torch.Tensor
    jt: object


def _cg_options(ops, options: Options) -> None:
    ops.eta = options.eta
    ops.min_li = options.min_linear_solver_iterations
    ops.max_li = options.max_linear_solver_iterations


# the preconditioners of the jt-mode ITERATIVE_SCHUR step; the others and
# the SPSE initial guess take the flat step (fused_lm.py:294-298)
_SCHUR_JACOBI_OR_NONE = (PreconditionerType.SCHUR_JACOBI, PreconditionerType.IDENTITY)
_CLUSTER = (PreconditionerType.CLUSTER_JACOBI, PreconditionerType.CLUSTER_TRIDIAGONAL)


def _iterative_options(ops, options: Options) -> None:
    """The ITERATIVE_SCHUR step's options; JACOBI runs as SCHUR_JACOBI
    (fused_lm.py:237-239), the power series over
    max(1, max_num_spse_iterations) terms (fused_lm.py:245-246)."""
    prec = options.preconditioner_type
    if prec == PreconditionerType.JACOBI:
        prec = PreconditionerType.SCHUR_JACOBI
    if prec not in _SCHUR_JACOBI_OR_NONE + _CLUSTER + (
            PreconditionerType.SCHUR_POWER_SERIES_EXPANSION,):
        raise ValueError(f"fused ITERATIVE_SCHUR: unsupported preconditioner {prec}")
    ops.precond = prec
    ops.spse_terms = max(1, options.max_num_spse_iterations)
    ops.spse_init = options.use_spse_initialization
    _cg_options(ops, options)


def _cg(ops, lhs, rhs, precond, fetch, x0=None):
    return conjugate_gradients(
        lhs, rhs, torch.zeros_like(rhs) if x0 is None else x0, precond,
        min_num_iterations=ops.min_li, max_num_iterations=ops.max_li,
        residual_reset_period=10, r_tolerance=-1.0, q_tolerance=ops.eta,
        fetch=fetch)


class _JTStepOps:
    """What both Schur steps share: the e/f partition, the row plan and
    the fused jt-mode evaluation and post-evaluation."""

    def __init__(self, program, e_families):
        self.program = program
        self.pm = pt.build_partition(bsr.build_meta(program), e_families)
        self.flat = fo.JTSchurOps(self.pm, program)
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


class DenseSchurStepOps(_JTStepOps):
    """Exact dense-Schur LM step on the jt-mode kernel path: eliminate the
    points in closed form through per-point K = L^{-1}, assemble the
    reduced camera system with schur_assembly, solve it, back-substitute
    with normal_matvec (fused_lm.py:891-975)."""

    def __init__(self, program, options: Options, e_families):
        super().__init__(program, e_families)
        self.flat.plan.ensure_pairs()

    def _scaled_K(self, ete, se, d2e):
        """Per-point K = L^{-1} of scaled E'E + D_e^2, (P, 9) rows."""
        return fo.chol_inv_lower_flat(fo.scaled_blocks(ete, se, d2e, kn.TE), kn.TE)

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

    def compute_step(self, vrep: JTForm, aux, g, scale_c, D2_c, fetch):
        """(step, model cost change, linear iterations = 1) of
        (J_s'J_s + D^2) y = -J_s'r."""
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
        normal = fl.make_kernel_suite_raw(vrep.jt, se, sf)[2]
        _, ptv = normal(z, torch.zeros((P, te), dtype=z.dtype, device=z.device))
        Az = self._kmatvec(K, ptv.reshape(-1))
        y_e = self._kmatvec(K, u_vec - Az, transpose=True)
        step = -pt.combine(pm, y_e, z)
        # exact-solve identity: -m(d) = -1/2 g_s'd + 1/2 d'D^2 d
        g_dot = torch.dot(b, step)
        d2_dot = torch.dot(D2_c * step, step)
        return step, -0.5 * g_dot + 0.5 * d2_dot, 1


class IterativeSchurStepOps(_JTStepOps):
    """Implicit-Schur PCG (iterative_schur_complement_solver.cc:64) on the
    jt-mode kernel path, in its scale-folded form (fused_lm.py:219-583):
    the rhs and the model cost change through normal_matvec, S z through
    isc_matvec once per CG iteration, the SCHUR_JACOBI preconditioner
    through schur_jacobi_blocks once per LM iteration, and the point
    back-substitution from isc_matvec's u."""

    def __init__(self, program, options: Options, e_families):
        super().__init__(program, e_families)
        _iterative_options(self, options)
        if self.precond not in _SCHUR_JACOBI_OR_NONE or self.spse_init:
            raise ValueError("the jt step runs SCHUR_JACOBI or IDENTITY alone")

    def compute_step(self, vrep: JTForm, aux, g, scale_c, D2_c, fetch):
        """(step, model cost change, CG iterations) of
        (J_s'J_s + D^2) y = -J_s'r by PCG on the Schur complement."""
        pm, fl = self.pm, self.flat
        P, te, tf = fl.P, kn.TE, kn.TF
        (ete,) = aux
        se = pt.extract_e(pm, scale_c)
        sf = pt.extract_f(pm, scale_c)
        d2f = pt.extract_f(pm, D2_c)
        minv_e = fo.scaled_block_inverses(ete, se, pt.extract_e(pm, D2_c), te)
        matvec, jacobi_blocks, normal, fold_minv = fl.make_kernel_suite_raw(
            vrep.jt, se, sf)
        minv0 = fold_minv(minv_e)

        # rhs = F_s'(b - E_s Minv E_s'b): F_s'E_s u0 is the camera output
        # of the normal product at [0; u0]
        etb = se * pt.extract_e(pm, g)
        u0 = fo.apply_inverse_rows(minv_e, etb, te)
        camF, _ = normal(torch.zeros_like(d2f), u0.reshape(P, te))
        rhs = sf * pt.extract_f(pm, g) - camF

        def lhs(z):
            return matvec(z, minv0)[0] + d2f * z

        precond = None
        if self.precond == PreconditionerType.SCHUR_JACOBI:
            inv_f = jacobi_blocks(minv_e, d2f)

            def precond(v):
                return fo.apply_inverse_rows(inv_f, v, tf)

        res = _cg(self, lhs, rhs, precond, fetch)
        z = res.x
        # back substitution: y_e = Minv (E_s'b - E_s'F_s z) = u0 - u(z)
        _, u_fin = matvec(z, minv0, emit_u=True)
        y_e = u0 - u_fin
        step = -pt.combine(pm, y_e, z)
        # mr'r = step'(scale g), mr'mr = step'H_s step through one normal pass
        ye_rows = (-y_e).reshape(P, te)
        camH, ptH = normal(-z, ye_rows)
        mr_r = torch.dot(step, scale_c * g)
        mr_mr = torch.dot(-z, camH) + torch.sum(ye_rows * ptH)
        return step, -(mr_r + 0.5 * mr_mr), res.num_iterations


def _flat_evaluate(program, x):
    """(cost, blocks flattened to (B, r*t) per kind and slot, residuals):
    the plain evaluation (fused_lm.py:164-167, :305-307)."""
    o = program._eval_core(x)
    vflat = tuple(tuple(J.reshape(J.shape[0], -1) for J in jacs)
                  for jacs in o["block_jacs"])
    return o["cost"], vflat, o["residuals"]


class _FlatStepOps:
    """What both flat Schur steps share: the e/f partition, the flat plans,
    the plain evaluation with its blocks flattened (fused_lm.py:305-307)
    and the flat post-evaluation (fused_lm.py:347-352)."""

    def __init__(self, program, e_families):
        self.program = program
        self.pm = pt.build_partition(bsr.build_meta(program), e_families)
        self.flat = fo.FlatSchurOps(self.pm, program)

    def evaluate(self, x):
        """(cost f64 0-d, FlatForm) at state x."""
        cost, vflat, r = _flat_evaluate(self.program, x)
        return cost, FlatForm(vflat, r)

    def post_eval(self, vrep: FlatForm):
        """(gradient J'r, column norms diag(J'J), aux = ([E'E blocks per
        e family], [F'F blocks per f family]))."""
        fl, pm = self.flat, self.pm
        g_e, sqn_e, ete = fl.fused_post_eval_e(vrep.vflat, vrep.r)
        g_f, sqn_f, ftf = fl.fused_post_eval_f(vrep.vflat, vrep.r)
        return pt.combine(pm, g_e, g_f), pt.combine(pm, sqn_e, sqn_f), (ete, ftf)

    def _scaled_jac(self, vflat, k, p, scale):
        """(B, r, t) block of slot p with each row's column scales."""
        return self.flat._jac(vflat, k, p) * self.flat._gather(scale, p)[:, None, :]


class FlatIterativeSchurStepOps(_FlatStepOps):
    """Implicit-Schur PCG on the flat path (fused_lm.py:453-583 without
    the kernel suite): S z through the product chain of right/left
    products, SCHUR_JACOBI from the carried F'F blocks less the
    per-observation W' M^{-1} W (fused_lm.py:354-409), the power series
    over it as preconditioner or initial guess (fused_lm.py:537-553), or
    the cluster preconditioners from the scaled blocks
    (fused_lm.py:411-450)."""

    def __init__(self, program, options: Options, e_families):
        super().__init__(program, e_families)
        _iterative_options(self, options)
        if self.precond in _CLUSTER:
            from .linear.preconditioners import build_cluster

            self.cluster_structure, self.cluster_assembler = build_cluster(
                self.pm, self.flat, options.visibility_clustering_type,
                self.precond == PreconditionerType.CLUSTER_TRIDIAGONAL)

    def _cluster_precond(self, vflat, scale_c, D2_c):
        """CLUSTER_JACOBI / CLUSTER_TRIDIAGONAL from the scaled blocks (the
        CG products stay on the flat ones)."""
        from .linear.preconditioners import (make_cluster_preconditioner,
                                             make_cluster_tridiagonal_preconditioner)

        pm = self.pm
        blocks = self.cluster_assembler(self.flat.scale_columns(vflat, scale_c),
                                        torch.sqrt(pt.extract_e(pm, D2_c)),
                                        torch.sqrt(pt.extract_f(pm, D2_c)))
        make = (make_cluster_tridiagonal_preconditioner
                if self.precond == PreconditionerType.CLUSTER_TRIDIAGONAL
                else make_cluster_preconditioner)
        return make(self.cluster_structure, lambda: blocks)

    def _schur_jacobi_inverses(self, vflat, ftf, minv_e, se, sf, d2f):
        fl = self.flat
        tables = [torch.cat([M, M.new_zeros((1, M.shape[1]))])
                  for M in fl.scaled_blocks(self.pm.f_fams, ftf, sf, d2f)]
        for k, kind in enumerate(fl.kinds):
            if not fl.plans_e[k] or not fl.plans_f[k]:
                continue
            pe = fl.plans_e[k][0]
            Je = self._scaled_jac(vflat, k, pe, se)
            minv_rows = fl._expand(minv_e[pe.fi], pe).reshape(kind.B, pe.t, pe.t)
            for pf in fl.plans_f[k]:
                W = fo.small_matmul(Je.transpose(1, 2), self._scaled_jac(vflat, k, pf, sf))
                corr = fo.small_matmul(W.transpose(1, 2), fo.small_matmul(minv_rows, W))
                tables[pf.fi] = fl._reduce_rows(tables[pf.fi], pf,
                                                -corr.reshape(kind.B, -1))
        return [fo.spd_inverse_flat(tab[:nv], t)
                for tab, (_, nv, t, _) in zip(tables, self.pm.f_fams)]

    def compute_step(self, vrep: FlatForm, aux, g, scale_c, D2_c, fetch):
        """(step, model cost change, CG iterations) of
        (J_s'J_s + D^2) y = -J_s'r by PCG on the Schur complement."""
        fl, pm = self.flat, self.pm
        vflat, r = vrep
        ete, ftf = aux
        se = pt.extract_e(pm, scale_c)
        sf = pt.extract_f(pm, scale_c)
        d2f = pt.extract_f(pm, D2_c)
        minv_e = fl.scaled_block_inverses(pm.e_fams, ete, se, pt.extract_e(pm, D2_c))

        def minv(v):
            return fl.apply_inverse_rows(pm.e_fams, minv_e, v)

        # rhs = F_s'(r - E_s Minv E_s'r) (implicit_schur_complement.cc:49)
        etb = se * pt.extract_e(pm, g)
        rhs = sf * fl.left_f(vflat, r - fl.right_e(vflat, se * minv(etb)))

        def lhs(z):
            fz = fl.right_f(vflat, sf * z)
            etfz = se * fl.left_e(vflat, fz)
            e_part = fl.right_e(vflat, se * minv(etfz))
            return sf * fl.left_f(vflat, fz - e_part) + d2f * z

        precond, x0 = None, None
        if self.precond in (PreconditionerType.SCHUR_JACOBI,
                            PreconditionerType.SCHUR_POWER_SERIES_EXPANSION) or self.spse_init:
            from .linear.preconditioners import power_series

            inv_f = self._schur_jacobi_inverses(vflat, ftf, minv_e, se, sf, d2f)

            def p_inv(v):
                return fl.apply_inverse_rows(pm.f_fams, inv_f, v)

            if self.precond == PreconditionerType.SCHUR_JACOBI:
                precond = p_inv
            elif self.precond == PreconditionerType.SCHUR_POWER_SERIES_EXPANSION:
                precond = power_series(p_inv, lhs, self.spse_terms)
            if self.spse_init:
                x0 = power_series(p_inv, lhs, self.spse_terms)(rhs)
        if self.precond in _CLUSTER:
            precond = self._cluster_precond(vflat, scale_c, D2_c)

        res = _cg(self, lhs, rhs, precond, fetch, x0)
        z = res.x
        # back substitution: y_e = Minv (E_s'b - E_s'F_s z)
        y_e = minv(etb - se * fl.left_e(vflat, fl.right_f(vflat, sf * z)))
        step = -pt.combine(pm, y_e, z)
        mr = fl.right_e(vflat, se * (-y_e)) + fl.right_f(vflat, sf * (-z))
        return step, -torch.dot(mr, r + mr / 2.0), res.num_iterations


class FlatDenseSchurStepOps(_FlatStepOps):
    """Exact dense-Schur LM step on the flat path (fused_lm.py:601-1027,
    without the one-kernel assembly): eliminate the e-blocks through
    per-block K = L^{-1}, assemble A = K W densely (segment_spread_sum on
    rows sorted by the e-block) and S = scaled F'F + D_f^2 + the cross
    terms of two f-blocks of one residual - A'A, solve the reduced
    system, back-substitute through A. With use_mixed_precision_solves
    and a float64 evaluation, the system is assembled and factored in
    float32 and the step refined in float64 through the flat products
    (fused_lm.py:982-1020)."""

    def __init__(self, program, options: Options, e_families):
        super().__init__(program, e_families)
        self.mixed = options.use_mixed_precision_solves
        self.refine = max(1, options.max_num_refinement_iterations)

    def _scaled_K(self, ete, se, d2e):
        """Per e family K = L^{-1} of scaled E'E + D_e^2, (nv, t*t)."""
        return [fo.chol_inv_lower_flat(M, t) for M, (_, _, t, _) in zip(
            self.flat.scaled_blocks(self.pm.e_fams, ete, se, d2e), self.pm.e_fams)]

    def _kmatvec(self, K_e, v, transpose=False):
        """Blockwise K v (or K' v) over the e-partition layout."""
        outs = []
        for (off, nv, t, _), K in zip(self.pm.e_fams, K_e):
            Kb = K.reshape(nv, t, t)
            if transpose:
                Kb = Kb.transpose(1, 2)
            outs.append(fo.small_matmul(Kb, v[off:off + nv * t].reshape(nv, t, 1))
                        .reshape(-1))
        return torch.cat(outs) if outs else v

    @staticmethod
    def _spread(W, p, f_size):
        """(B, ti*f_size): W (B, ti, tj) in the column window of each row's
        block of slot p, zero for the sentinel (fused_lm.py:586)."""
        B, ti, tj = W.shape
        block = torch.clamp(p.local.long(), max=p.nv - 1)
        cols = p.off + block[:, None] * tj + torch.arange(tj, device=W.device)
        valid = (p.local < p.nv).to(W.dtype)[:, None, None]
        T = W.new_zeros((B, ti, f_size))
        T.scatter_(2, cols[:, None, :].expand(B, ti, tj), W * valid)
        return T.reshape(B, ti * f_size)

    def eliminated_rows(self, vflat, K_e, se, sf):
        """(pe, pf, Y (B, te, tf) = K_p W_b with W_b = J_e,s' J_f,s) for
        each (kind, f-slot) of a kind with an e-slot: the rows of A."""
        fl = self.flat
        for k, kind in enumerate(fl.kinds):
            if not fl.plans_e[k] or not fl.plans_f[k]:
                continue
            pe = fl.plans_e[k][0]
            Je = self._scaled_jac(vflat, k, pe, se)
            K_rows = fl._expand(K_e[pe.fi], pe).reshape(kind.B, pe.t, pe.t)
            for pf in fl.plans_f[k]:
                W = fo.small_matmul(Je.transpose(1, 2), self._scaled_jac(vflat, k, pf, sf))
                yield pe, pf, fo.small_matmul(K_rows, W)

    def _assemble(self, vrep: FlatForm, aux, scale_c, D2_c):
        """(K_e, A (e_size, f_size), S (f_size, f_size)) of the
        eliminated system (fused_lm.py:667-816)."""
        fl, pm = self.flat, self.pm
        vflat = vrep.vflat
        ete, ftf = aux
        se = pt.extract_e(pm, scale_c)
        sf = pt.extract_f(pm, scale_c)
        f_size = pm.f_size
        K_e = self._scaled_K(ete, se, pt.extract_e(pm, D2_c))

        # A = K W: one spread sum per (kind, f-slot)
        tables = [scale_c.new_zeros((nv, t, f_size)) for (_, nv, t, _) in pm.e_fams]
        for pe, pf, Y in self.eliminated_rows(vflat, K_e, se, sf):
            te = pe.t
            if pe.srt:
                Afam = kn.segment_spread_sum(
                    Y.reshape(Y.shape[0], -1), pf.local, pe.seg.seg_start[:pe.nv + 1],
                    pf.nv, te, pf.t)
                tables[pe.fi][:, :, pf.off:pf.off + pf.nv * pf.t] += Afam.reshape(
                    pe.nv, te, pf.nv * pf.t)
            else:
                rows = fl._reduce_rows(None, pe, self._spread(Y, pf, f_size))
                tables[pe.fi] += rows[:pe.nv].reshape(pe.nv, te, f_size)
        A = torch.cat([tab.reshape(-1, f_size) for tab in tables])

        # S = scaled F'F + diag(D_f^2) on the diagonal blocks, plus the
        # cross terms of two distinct f-blocks of one residual, - A'A
        S = scale_c.new_zeros((f_size, f_size))
        for (off, nv, t, _), M in zip(pm.f_fams, fl.scaled_blocks(
                pm.f_fams, ftf, sf, pt.extract_f(pm, D2_c))):
            eye = torch.eye(nv, dtype=M.dtype, device=M.device)
            S[off:off + nv * t, off:off + nv * t] = torch.einsum(
                "cij,cd->cidj", M.reshape(nv, t, t), eye).reshape(nv * t, nv * t)
        for k, kind in enumerate(fl.kinds):
            fs = fl.plans_f[k]
            for p1 in fs:
                for p2 in fs:
                    if p1 is p2:
                        continue
                    W12 = fo.small_matmul(self._scaled_jac(vflat, k, p1, sf).transpose(1, 2),
                                          self._scaled_jac(vflat, k, p2, sf))
                    if p1.fi == p2.fi:  # the same block twice: the diagonal term
                        W12 = W12 * (p1.local != p2.local).to(W12.dtype)[:, None, None]
                    rows = fl._reduce_rows(None, p1, self._spread(W12, p2, f_size))
                    S[p1.off:p1.off + p1.nv * p1.t] += rows[:p1.nv].reshape(-1, f_size)
        return K_e, A, S - A.T @ A

    def _solve(self, K_e, A, S, b):
        """y of (J_s'J_s + D^2) y = b through the eliminated system
        (fused_lm.py:844-854)."""
        pm = self.pm
        u_b = self._kmatvec(K_e, pt.extract_e(pm, b))
        z = reduced_solve(S, pt.extract_f(pm, b) - A.T @ u_b)
        y_e = self._kmatvec(K_e, u_b - A @ z, transpose=True)
        return pt.combine(pm, y_e, z)

    def _normal64(self, vflat, scale_c, D2_c, v):
        """(J_s'J_s + D^2) v through the flat products (fused_lm.py:1004-1010)."""
        fl, pm = self.flat, self.pm
        sv = scale_c * v
        jv = fl.right_e(vflat, pt.extract_e(pm, sv)) + fl.right_f(vflat, pt.extract_f(pm, sv))
        return scale_c * pt.combine(pm, fl.left_e(vflat, jv), fl.left_f(vflat, jv)) + D2_c * v

    def compute_step(self, vrep: FlatForm, aux, g, scale_c, D2_c, fetch):
        """(step, model cost change, linear iterations = 1) of
        (J_s'J_s + D^2) y = -J_s'r (fused_lm.py:818-854, :982-1027)."""
        b = scale_c * g
        if self.mixed and g.dtype == torch.float64:
            f32 = torch.float32
            vrep32 = FlatForm(tuple(tuple(J.to(f32) for J in jacs) for jacs in vrep.vflat),
                              vrep.r.to(f32))
            aux32 = tuple([blk.to(f32) for blk in part] for part in aux)
            factors = self._assemble(vrep32, aux32, scale_c.to(f32), D2_c.to(f32))

            def solve(rhs):
                return self._solve(*factors, rhs.to(f32)).to(torch.float64)

            y = solve(b)
            for _ in range(self.refine):
                y = y + solve(b - self._normal64(vrep.vflat, scale_c, D2_c, y))
        else:
            y = self._solve(*self._assemble(vrep, aux, scale_c, D2_c), b)
        step = -y
        # exact-solve identity: -m(d) = -1/2 g_s'd + 1/2 d'D^2 d
        return step, -0.5 * torch.dot(b, step) + 0.5 * torch.dot(D2_c * step, step), 1


class ExplicitSchurStepOps(FlatDenseSchurStepOps):
    """use_explicit_schur_complement in the fused loop
    (fused_lm.py:1030-1095; schur_complement_solver.cc:338): S assembled
    densely by the flat dense-Schur step (rows 8, 6, 7 and 9), PCG on it
    with its product a plain matmul, as the JAX step's is a plain jnp.matmul
    outside any kernel, and SCHUR_JACOBI blocks read off S's block diagonal
    (JACOBI runs as SCHUR_JACOBI), or no preconditioner (IDENTITY)."""

    def __init__(self, program, options: Options, e_families):
        super().__init__(program, options, e_families)
        prec = options.preconditioner_type
        if prec == PreconditionerType.JACOBI:
            prec = PreconditionerType.SCHUR_JACOBI
        if prec not in _SCHUR_JACOBI_OR_NONE:
            raise ValueError(
                f"fused explicit-S ITERATIVE_SCHUR: unsupported preconditioner {prec}")
        self.precond = prec
        _cg_options(self, options)

    def compute_step(self, vrep: FlatForm, aux, g, scale_c, D2_c, fetch):
        """(step, model cost change, CG iterations)."""
        fl, pm = self.flat, self.pm
        K_e, A, S = self._assemble(vrep, aux, scale_c, D2_c)
        b = scale_c * g
        u_b = self._kmatvec(K_e, pt.extract_e(pm, b))
        rhs = pt.extract_f(pm, b) - A.T @ u_b
        precond = None
        if self.precond == PreconditionerType.SCHUR_JACOBI:
            inv_f = []
            for (off, nv, t, _) in pm.f_fams:
                blk = S[off:off + nv * t, off:off + nv * t].reshape(nv, t, nv, t)
                diag = torch.diagonal(blk, dim1=0, dim2=2).permute(2, 0, 1)  # (nv, t, t)
                inv_f.append(fo.spd_inverse_flat(diag.reshape(nv, t * t), t))

            def precond(v):
                return fl.apply_inverse_rows(pm.f_fams, inv_f, v)

        res = _cg(self, lambda z: S @ z, rhs, precond, fetch)
        z = res.x
        y_e = self._kmatvec(K_e, u_b - A @ z, transpose=True)
        step = -pt.combine(pm, y_e, z)
        sstep = scale_c * step
        mr = (fl.right_e(vrep.vflat, pt.extract_e(pm, sstep))
              + fl.right_f(vrep.vflat, pt.extract_f(pm, sstep)))
        return step, -torch.dot(mr, vrep.r + mr / 2.0), res.num_iterations


class CgnrStepOps:
    """CGNR over the flat block Jacobian (cgnr_solver.cc, fused_lm.py:148-206):
    conjugate gradients on (J_s'J_s + D^2) y = -J_s'r with the Jacobi scales
    folded into the vectors, through normal_matvec (kernel 4) on a
    BAL-shaped program and the right/left product chain on any other, with
    the block-Jacobi preconditioner of the carried unscaled J'J blocks
    (JACOBI and SCHUR_JACOBI) or none (IDENTITY)."""

    def __init__(self, program, options: Options):
        self.program = program
        self.flat = fo.FlatJacobianOps(bsr.build_meta(program), program)
        prec = options.preconditioner_type
        if prec not in (PreconditionerType.JACOBI, PreconditionerType.SCHUR_JACOBI,
                        PreconditionerType.IDENTITY):
            raise ValueError(f"fused CGNR: unsupported preconditioner {prec}")
        self.precond = prec != PreconditionerType.IDENTITY
        _cg_options(self, options)

    def evaluate(self, x):
        """(cost f64 0-d, CgnrForm) at state x."""
        cost, vflat, r = _flat_evaluate(self.program, x)
        return cost, CgnrForm(vflat, r, self.flat.kernel_lanes(vflat))

    def post_eval(self, vrep: CgnrForm):
        """(gradient J'r, column norms diag(J'J), aux = the J'J blocks of
        each family when preconditioned)."""
        g, sqn, blocks = self.flat.fused_post_eval_all(vrep.vflat, vrep.r)
        return g, sqn, tuple(blocks) if self.precond else ()

    def compute_step(self, vrep: CgnrForm, aux, g, scale_c, D2_c, fetch):
        """(step, model cost change, CG iterations)."""
        fl = self.flat
        kern = fl.make_kernel_matvec(vrep.jt, scale_c)
        if kern is not None:
            def lhs(x):
                return kern(x) + D2_c * x
        else:
            def lhs(x):
                return scale_c * fl.left(vrep.vflat, fl.right(vrep.vflat, scale_c * x)) \
                    + D2_c * x

        precond = None
        if self.precond:
            invs = fl.scaled_block_inverses(fl.fams, aux, scale_c, D2_c)

            def precond(v):
                return fl.apply_inverse_rows(fl.fams, invs, v)

        res = _cg(self, lhs, scale_c * g, precond, fetch)
        step = -res.x
        mr = fl.right(vrep.vflat, scale_c * step)
        return step, -torch.dot(mr, vrep.r + mr / 2.0), res.num_iterations


class DenseStepOps:
    """The dense-Jacobian step, DENSE_QR or DENSE_NORMAL_CHOLESKY
    (fused_lm.py:1100-1139): J assembled densely in float64 at each
    evaluation, the scaled system solved by torch.linalg as the JAX
    package solves it outside any kernel; DENSE_NORMAL_CHOLESKY with
    use_mixed_precision_solves factors in float32 and refines in float64
    (solvers/linear/dense.normal_cholesky_solve_mixed)."""

    def __init__(self, program, options: Options, tier: str):
        self.program = program
        self.solve = {"dense_qr": qr_solve,
                      "dense_normal_cholesky": normal_cholesky_solve}[tier]
        if tier == "dense_normal_cholesky" and options.use_mixed_precision_solves:
            steps = max(1, options.max_num_refinement_iterations)

            def solve(J, r, D):
                return normal_cholesky_solve_mixed(J, r, D, refinement_steps=steps)

            self.solve = solve

    def evaluate(self, x):
        """(cost f64 0-d, DenseForm) at state x."""
        o = self.program._eval_core(x, dense_jac=True)
        return o["cost"], DenseForm(o["jacobian"], o["residuals"])

    def post_eval(self, vrep: DenseForm):
        J, r = vrep
        return J.T @ r.to(J.dtype), torch.sum(J * J, dim=0), ()

    def compute_step(self, vrep: DenseForm, aux, g, scale_c, D2_c, fetch):
        """(step, model cost change, linear iterations = 1)."""
        J, r = vrep
        r = r.to(J.dtype)
        Js = J * scale_c.to(J.dtype)[None, :]
        step = -self.solve(Js, r, torch.sqrt(D2_c).to(J.dtype))
        mr = Js @ step
        return step, -torch.dot(mr, r + mr / 2.0), 1


class DoglegStepOps:
    """TRADITIONAL_DOGLEG and SUBSPACE_DOGLEG (dogleg_strategy.cc:56) over an
    exact step, as the JAX DoglegOpsWrapper computes them
    (fused_lm.py:1142-1326): the wrapped step's solve at the LM diagonal
    mu * diag gives the Gauss-Newton point, escalating mu tenfold while
    that point is not finite (each test one host sync); one J v product
    gives the Cauchy alpha; the piecewise dogleg path, or on SUBSPACE the
    minimizer of the 2-D model on the radius circle, by the trig-form
    theta-grid argmin with Newton refinement (not the reference's
    quartic, which would change the answer). The loop applies the dogleg
    radius and mu rules."""

    strategy = "dogleg"
    _K_MAX_MU = 1.0

    def __init__(self, inner, subspace: bool = False):
        self.inner = inner
        self.program = inner.program
        self.subspace = subspace

    def evaluate(self, x):
        return self.inner.evaluate(x)

    def post_eval(self, vrep):
        return self.inner.post_eval(vrep)

    def _jv(self, vrep, v):
        """J v in residual space."""
        inner = self.inner
        if isinstance(inner, DenseStepOps):
            return vrep.J @ v.to(vrep.J.dtype)
        fl, pm = inner.flat, inner.pm
        return (fl.right_e(vrep.vflat, pt.extract_e(pm, v))
                + fl.right_f(vrep.vflat, pt.extract_f(pm, v)))

    def _jv_norm2(self, vrep, v):
        jv = self._jv(vrep, v)
        return torch.dot(jv, jv)

    def _subspace_step(self, vrep, escale_c, D, g_s, gn_s, radius):
        """(step_s, ok) of the boundary minimizer of the model on the plane
        of g and the Gauss-Newton point (fused_lm.py:1178-1250); ok False
        (a rank-deficient basis or a non-optimal cosine) keeps the
        traditional step."""
        cdt, f64 = escale_c.dtype, torch.float64
        g_norm = torch.linalg.vector_norm(g_s)
        u1 = g_s / torch.clamp(g_norm, min=1e-300)
        w = gn_s - torch.dot(u1, gn_s) * u1
        wn = torch.linalg.vector_norm(w)
        scale = torch.maximum(torch.linalg.vector_norm(gn_s), g_norm)
        rank2 = wn > 1e-14 * torch.clamp(scale, min=1.0)
        u2 = w / torch.clamp(wn, min=1e-300)
        sg0, sg1 = torch.dot(u1, g_s), torch.dot(u2, g_s)
        jb1 = self._jv(vrep, escale_c * (u1 / D).to(cdt)).to(f64)
        jb2 = self._jv(vrep, escale_c * (u2 / D).to(cdt)).to(f64)
        b11, b12, b22 = torch.dot(jb1, jb1), torch.dot(jb1, jb2), torch.dot(jb2, jb2)
        r2 = radius * radius
        # f(th) = 0.25 r^2 (b11 + b22) + P cos 2th + Q sin 2th + S cos th + T sin th
        Pc, Qc = 0.25 * r2 * (b11 - b22), 0.5 * r2 * b12
        Sc, Tc = radius * sg0, radius * sg1

        def f(th):
            return (Pc * torch.cos(2 * th) + Qc * torch.sin(2 * th)
                    + Sc * torch.cos(th) + Tc * torch.sin(th))

        def fp(th):
            return (-2 * Pc * torch.sin(2 * th) + 2 * Qc * torch.cos(2 * th)
                    - Sc * torch.sin(th) + Tc * torch.cos(th))

        def fpp(th):
            return (-4 * Pc * torch.cos(2 * th) - 4 * Qc * torch.sin(2 * th)
                    - Sc * torch.cos(th) - Tc * torch.sin(th))

        grid = torch.linspace(0.0, 2.0 * np.pi, 129, dtype=f64, device=g_s.device)[:-1]
        th0 = grid[torch.argmin(f(grid))]
        th = th0
        for _ in range(5):  # Newton on f' within the argmin basin
            upd = fp(th) / torch.clamp(fpp(th), min=1e-300)
            th = th - torch.where(fpp(th) > 0, upd, torch.zeros_like(upd))
        th = torch.where(f(th) <= f(th0), th, th0)
        x0, x1 = radius * torch.cos(th), radius * torch.sin(th)
        gm0 = b11 * x0 + b12 * x1 + sg0
        gm1 = b12 * x0 + b22 * x1 + sg1
        denom = torch.sqrt(x0 * x0 + x1 * x1) * torch.sqrt(gm0 * gm0 + gm1 * gm1)
        cosine = -(x0 * gm0 + x1 * gm1) / torch.clamp(denom, min=1e-300)
        return x0 * u1 + x1 * u2, rank2 & (cosine >= 0.99)

    def compute_dogleg_step(self, vrep, aux, g, escale_c, diag64, radius: float,
                            mu: float, fetch):
        """(step, model cost change, linear iterations = 1, the dogleg
        step's norm (0-d, scaled space), mu after escalation), in the
        escale coordinates with the ellipse substitution y = D x,
        D = sqrt(diag) (fused_lm.py:1252-1326)."""
        cdt, f64 = g.dtype, torch.float64
        D = torch.sqrt(diag64)
        g_t = escale_c * g
        g_s = g_t.to(f64) / D
        g_s_norm2 = torch.dot(g_s, g_s)
        jgd = self._jv_norm2(vrep, escale_c * (g_s / D).to(cdt))
        alpha = g_s_norm2 / torch.clamp(jgd.to(f64), min=1e-300)

        # the Gauss-Newton point, mu x10 while it is not finite
        # (dogleg_strategy.cc ComputeGaussNewtonStep)
        def gn_solve(m):
            return self.inner.compute_step(vrep, aux, g, escale_c,
                                           (m * diag64).to(cdt), fetch)[0]

        gn = gn_solve(mu)
        (ok,) = fetch(torch.isfinite(gn).all())
        while ok == 0.0 and mu < self._K_MAX_MU:
            mu = mu * 10.0
            gn = gn_solve(mu)
            (ok,) = fetch(torch.isfinite(gn).all())
        gn_s = gn.to(f64) * D
        gn_norm = torch.linalg.vector_norm(gn_s)
        g_norm = torch.sqrt(g_s_norm2)

        # the piecewise dogleg path (dogleg_strategy.cc ComputeTraditional...)
        case_gn = gn_norm <= radius
        case_cauchy = alpha * g_norm >= radius
        a_dot_b = -alpha * torch.dot(g_s, gn_s)
        a2 = (alpha * g_norm) ** 2
        b_minus_a2 = torch.clamp(a2 - 2.0 * a_dot_b + gn_norm ** 2, min=1e-300)
        c = a_dot_b - a2
        disc = torch.sqrt(torch.clamp(c * c + b_minus_a2 * (radius ** 2 - a2), min=0.0))
        beta = torch.where(c <= 0.0, (disc - c) / b_minus_a2,
                           (radius ** 2 - a2) / torch.clamp(disc + c, min=1e-300))
        blend = (-alpha * (1.0 - beta)) * g_s + beta * gn_s
        rad = torch.full_like(gn_norm, radius)
        trad_s = torch.where(case_cauchy,
                             -(radius / torch.clamp(g_norm, min=1e-300)) * g_s, blend)
        trad_norm = torch.where(case_cauchy, rad, torch.linalg.vector_norm(blend))
        if self.subspace:
            sub_s, sub_ok = self._subspace_step(vrep, escale_c, D, g_s, gn_s, radius)
            trad_s = torch.where(sub_ok, sub_s, trad_s)
            trad_norm = torch.where(sub_ok, rad, trad_norm)
        step = (torch.where(case_gn, gn_s, trad_s) / D).to(cdt)
        dl_norm = torch.where(case_gn, gn_norm, trad_norm)
        # model cost change: -(g'd + 1/2 |J_s d|^2)
        mcc = -(torch.dot(g_t, step) + 0.5 * self._jv_norm2(vrep, escale_c * step))
        if ok == 0.0:
            mcc = torch.full_like(mcc, -1.0)
        return step, mcc, 1, dl_norm, mu


class FusedTrustRegionMinimizer:
    """LM or dogleg over a step adapter with one host sync per iteration."""

    def __init__(self, program, options: Options, ops):
        self.program = program
        self.options = options
        self.ops = ops
        self.x_cost = float("nan")

    def _fetch(self, summary: Summary, *scalars):
        summary.num_host_syncs += 1
        return torch.stack([s.to(torch.float64).reshape(()) for s in scalars]).tolist()

    def _line_search(self, x, cost, g, delta, valid_t, summary: Summary):
        """The projected Armijo backtracking of a bounded step
        (fused_lm.py:1494-1528): the step scale halves from 1 until the
        cost of the projected point satisfies Armijo's condition, the
        scale falls under min_line_search_step_size or the probes run
        out; the scale kept is the last Armijo one or the best probe's,
        1 if none was finite and better. Each probe is a cost-only
        evaluation and one host sync, whose first also reads whether the
        step is valid (an invalid step skips the search)."""
        opts, program = self.options, self.program
        slope_t = torch.dot(g.to(torch.float64), delta)
        sdec = opts.line_search_sufficient_function_decrease
        ss, best_s, best_c = 1.0, -1.0, cost
        for i in range(int(opts.max_num_line_search_step_size_iterations)):
            probe_t = program.evaluate_cost(program.plus(x, ss * delta))
            if i == 0:
                valid, slope, probe = self._fetch(summary, valid_t, slope_t, probe_t)
                if valid == 0.0:
                    break
            else:
                (probe,) = self._fetch(summary, probe_t)
            finite = np.isfinite(probe)
            armijo = finite and probe <= cost + sdec * ss * slope
            if armijo or (finite and probe < best_c):
                best_s, best_c = ss, probe
            ss *= 0.5
            if armijo or ss < opts.min_line_search_step_size:
                break
        return (best_s if best_s > 0.0 else 1.0) * delta

    def minimize(self, x0: torch.Tensor, summary: Summary) -> torch.Tensor:
        opts, ops = self.options, self.ops
        cdt = self.program.compute_dtype
        max_iters = int(opts.max_num_iterations)
        min_d, max_d = opts.min_lm_diagonal, opts.max_lm_diagonal
        max_steps = (opts.max_consecutive_nonmonotonic_steps
                     if opts.use_nonmonotonic_steps else 0)
        active_mask = active_set_mask(self.program)
        if active_mask is not None:
            # project x0 onto the box (fused_lm.py:1358-1366)
            x0 = self.program.plus(x0, torch.zeros(self.program.tangent_size,
                                                   dtype=torch.float64, device=x0.device))

        cost_t, vrep = ops.evaluate(x0)
        g, sqn_c, aux = ops.post_eval(vrep)
        sqn = sqn_c.to(torch.float64)
        if opts.jacobi_scaling:
            scale = 1.0 / (1.0 + torch.sqrt(sqn))
        else:
            scale = torch.ones_like(sqn)
        scale_c = scale.to(cdt)
        gnorm_t, gmax_t = grad_norms(self.program, x0, g)
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
            step_is_successful=True, linear_solver_iterations=0, eta=opts.eta)]
        x = x0
        decrease_factor = 2.0
        dogleg = getattr(ops, "strategy", "lm") == "dogleg"
        mu = 1e-8  # dogleg's Gauss-Newton regularization (fused_lm.py:134)
        se = TrustRegionStepEvaluator(cost, max_steps)
        num_invalid = 0
        any_success = False
        min_cost, best_x = cost, x0
        it = 0

        while term == _RUNNING and it < max_iters:
            it += 1
            # -- the step (levenberg_marquardt_strategy.cc:69-120, or
            # -- dogleg_strategy.cc, fused_lm.py:1468-1475) -----------------
            if active_mask is not None:
                escale = scale * active_mask(x, g)
                escale_c = escale.to(cdt)
            else:
                escale, escale_c = scale, scale_c
            diag = torch.clamp(escale * escale * sqn, min_d, max_d)

            def fetch(*sc):
                return self._fetch(summary, *sc)

            if dogleg:
                step, mcc_c, lin_iters, dl_norm_t, mu_new = ops.compute_dogleg_step(
                    vrep, aux, g, escale_c, diag, radius, mu, fetch)
                extra = (dl_norm_t,)
            else:
                D2_c = (diag / radius).to(cdt)
                step, mcc_c, lin_iters = ops.compute_step(vrep, aux, g, escale_c, D2_c,
                                                          fetch)
                extra = ()
            mcc_t = mcc_c.to(torch.float64)
            valid_t = torch.isfinite(step).all() & (mcc_t > 0.0)
            delta = step.to(torch.float64) * escale
            if active_mask is not None and opts.max_num_line_search_step_size_iterations > 0:
                delta = self._line_search(x, cost, g, delta, valid_t, summary)
            cand_x = self.program.plus(x, delta)
            cand_cost_t, cand_vrep = ops.evaluate(cand_x)
            cand_g, cand_sqn, cand_aux = ops.post_eval(cand_vrep)
            cgnorm_t, cgmax_t = grad_norms(self.program, cand_x, cand_g)
            (valid_f, mcc, cand_cost, step_norm, x_norm, cgnorm,
             cgmax, *dl_norm) = self._fetch(
                summary, valid_t, mcc_t, cand_cost_t,
                torch.linalg.vector_norm(x - cand_x),
                torch.linalg.vector_norm(x), cgnorm_t, cgmax_t, *extra)
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
            rel_dec = se.step_quality(cand_cost, mcc)
            success = valid and not breaking and rel_dec > opts.min_relative_decrease
            if success:
                old_min = min_cost
                x, cost, vrep = cand_x, cand_cost, cand_vrep
                g, aux, sqn = cand_g, cand_aux, cand_sqn.to(torch.float64)
                gnorm, gmax = cgnorm, cgmax
                se.step_accepted(cand_cost, mcc)
                if cand_cost < old_min:
                    min_cost = cand_cost
                if cand_cost <= old_min:
                    best_x = cand_x

            # -- radius update -----------------------------------------------
            if breaking:
                radius_new = radius
                decrease_new = decrease_factor
            elif dogleg:  # dogleg_strategy.cc StepAccepted / StepRejected
                if success:
                    r_acc = radius * 0.5 if rel_dec < 0.25 else radius
                    if rel_dec > 0.75:
                        r_acc = max(r_acc, 3.0 * dl_norm[0])
                    radius_new = min(r_acc, opts.max_trust_region_radius)
                else:
                    radius_new = radius * 0.5
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
                trust_region_radius=radius_new, linear_solver_iterations=lin_iters,
                step_is_valid=valid, step_is_successful=success, eta=opts.eta))
            radius, decrease_factor = radius_new, decrease_new
            if dogleg:
                if success:
                    mu = max(1e-8, 2.0 * mu_new / 10.0)
                else:
                    mu = mu_new if valid else mu_new * 10.0
                mu = min(mu, 1.0)
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
        if opts.minimizer_progress_to_stdout:  # fused_lm.py:1762-1766
            from ..callbacks import trust_region_log_line

            for row in rows:
                print(trust_region_log_line(row))
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


# Schur tier -> (jt step, flat step)
_STEP_OPS = {"schur_dense": (DenseSchurStepOps, FlatDenseSchurStepOps),
             "schur_iterative": (IterativeSchurStepOps, FlatIterativeSchurStepOps)}
# the exact tiers dogleg runs on (fused_lm.py:1925-1929)
_DOGLEG_TIERS = ("schur_dense", "dense_qr", "dense_normal_cholesky")


def build_fused_minimizer(program, options: Options, tier: str, e_families=None):
    """Factory for the fused minimizer of a linear-solver tier
    (fused_lm.py:1921-1963): CGNR ("bsr"), DENSE_QR ("dense_qr"),
    DENSE_NORMAL_CHOLESKY ("dense_normal_cholesky"), or a Schur tier, its
    jt step for a program the jt path takes under Levenberg-Marquardt, its
    flat step for any other program, under DOGLEG and with mixed-precision
    solves (which leave the jt path, fused_lm.py:294-298, :628-636). DOGLEG wraps an exact step; on
    an iterative tier it returns None, as the JAX factory does, and the
    caller takes the host loop."""
    dogleg = options.trust_region_strategy_type == TrustRegionStrategyType.DOGLEG
    if dogleg and tier not in _DOGLEG_TIERS:
        return None
    try:
        if tier == "bsr":
            ops = CgnrStepOps(program, options)
        elif tier in ("dense_qr", "dense_normal_cholesky"):
            ops = DenseStepOps(program, options, tier)
        elif tier == "schur_iterative" and options.use_explicit_schur_complement:
            ops = ExplicitSchurStepOps(program, options, e_families)
        elif tier in _STEP_OPS:
            jt_ops, flat_ops = _STEP_OPS[tier]
            pm = pt.build_partition(bsr.build_meta(program), e_families)
            cls = (jt_ops if not dogleg and fo.jt_refusal(pm, program, options) is None
                   else flat_ops)
            ops = cls(program, options, e_families)
        else:
            raise NotImplementedError(f"fused tier {tier!r} is not ported")
    except ValueError:
        # outside the fused subset (fused_lm.py:1932-1950): CGNR with another
        # preconditioner than IDENTITY, JACOBI or SCHUR_JACOBI, SUBSET, the
        # explicit S with SPSE or CLUSTER_*
        return None
    if dogleg:
        ops = DoglegStepOps(ops, options.dogleg_type == DoglegType.SUBSPACE_DOGLEG)
    return FusedTrustRegionMinimizer(program, options, ops)
