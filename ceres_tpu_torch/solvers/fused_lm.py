"""Fused trust-region minimizer, Levenberg-Marquardt with the dense-Schur
or the iterative-Schur step (counterpart of ceres_tpu/solvers/fused_lm.py).

Each step has two forms, as the JAX classes do: the jt form
(`DenseSchurStepOps`, `IterativeSchurStepOps`) for the programs the fused
jt-mode kernels take (BAL), and the flat form (`FlatDenseSchurStepOps`,
`FlatIterativeSchurStepOps`) for every other program (the libmv bundle
adjuster): a plain evaluation, flattened Jacobian blocks and the flat
products of ops/flatops.FlatSchurOps. `build_fused_minimizer` routes by
`flatops.jt_refusal`.

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
tolerances and the termination taxonomy. The iterative-Schur step adds
one sync per CG iteration (solvers/linear/cg.py). Every sync is counted
in `Summary.num_host_syncs`. A loop that stays on the device is
ROADMAP.md port slice 4.
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
from ..types import PreconditionerType, TerminationType, not_ported
from .linear.cg import conjugate_gradients
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


class FlatForm(NamedTuple):
    """Evaluation result on the flat path: vflat[k][s] (B, r*t) Jacobian
    blocks of each kind and slot, r (N,) the residuals of every kind."""

    vflat: tuple
    r: torch.Tensor


def _iterative_options(ops, options: Options) -> None:
    """The ITERATIVE_SCHUR step's options; JACOBI runs as SCHUR_JACOBI
    (fused_lm.py:237-239)."""
    prec = options.preconditioner_type
    if prec == PreconditionerType.JACOBI:
        prec = PreconditionerType.SCHUR_JACOBI
    if prec not in (PreconditionerType.SCHUR_JACOBI, PreconditionerType.IDENTITY):
        raise not_ported(f"ITERATIVE_SCHUR with preconditioner {prec}", 6)
    ops.precond = prec
    ops.eta = options.eta
    ops.min_li = options.min_linear_solver_iterations
    ops.max_li = options.max_linear_solver_iterations


def _cg(ops, lhs, rhs, precond, fetch):
    return conjugate_gradients(
        lhs, rhs, torch.zeros_like(rhs), precond,
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
        o = self.program._eval_core(x)
        vflat = tuple(tuple(J.reshape(J.shape[0], -1) for J in jacs)
                      for jacs in o["block_jacs"])
        return o["cost"], FlatForm(vflat, o["residuals"])

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
    per-observation W' M^{-1} W (fused_lm.py:354-409)."""

    def __init__(self, program, options: Options, e_families):
        super().__init__(program, e_families)
        _iterative_options(self, options)

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

        precond = None
        if self.precond == PreconditionerType.SCHUR_JACOBI:
            inv_f = self._schur_jacobi_inverses(vflat, ftf, minv_e, se, sf, d2f)

            def precond(v):
                return fl.apply_inverse_rows(pm.f_fams, inv_f, v)

        res = _cg(self, lhs, rhs, precond, fetch)
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
    system, back-substitute through A."""

    def __init__(self, program, options: Options, e_families):
        super().__init__(program, e_families)

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
                rows = fl._reduce_rows(scale_c.new_zeros((pe.nv + 1, te * f_size)), pe,
                                       self._spread(Y, pf, f_size))
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
                    rows = fl._reduce_rows(
                        scale_c.new_zeros((p1.nv + 1, p1.t * f_size)), p1,
                        self._spread(W12, p2, f_size))
                    S[p1.off:p1.off + p1.nv * p1.t] += rows[:p1.nv].reshape(-1, f_size)
        return K_e, A, S - A.T @ A

    def compute_step(self, vrep: FlatForm, aux, g, scale_c, D2_c, fetch):
        """(step, model cost change, linear iterations = 1) of
        (J_s'J_s + D^2) y = -J_s'r (fused_lm.py:818-854, :1017-1027)."""
        pm = self.pm
        K_e, A, S = self._assemble(vrep, aux, scale_c, D2_c)
        b = scale_c * g
        u_b = self._kmatvec(K_e, pt.extract_e(pm, b))
        z = reduced_solve(S, pt.extract_f(pm, b) - A.T @ u_b)
        y_e = self._kmatvec(K_e, u_b - A @ z, transpose=True)
        step = -pt.combine(pm, y_e, z)
        # exact-solve identity: -m(d) = -1/2 g_s'd + 1/2 d'D^2 d
        return step, -0.5 * torch.dot(b, step) + 0.5 * torch.dot(D2_c * step, step), 1


def _grad_norms(program, x, g):
    """|x - Plus(x, -g)| and its max norm, in the ambient space
    (fused_lm.py:1396-1400)."""
    dx = x - program.plus(x, -g.to(torch.float64))
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
        gnorm_t, gmax_t = _grad_norms(self.program, x0, g)
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
            step, mcc_c, lin_iters = ops.compute_step(
                vrep, aux, g, scale_c, D2_c,
                lambda *sc: self._fetch(summary, *sc))
            mcc_t = mcc_c.to(torch.float64)
            valid_t = torch.isfinite(step).all() & (mcc_t > 0.0)
            cand_x = self.program.plus(x, step.to(torch.float64) * scale)
            cand_cost_t, cand_vrep = ops.evaluate(cand_x)
            cand_g, cand_sqn, cand_aux = ops.post_eval(cand_vrep)
            cgnorm_t, cgmax_t = _grad_norms(self.program, cand_x, cand_g)
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
                trust_region_radius=radius_new, linear_solver_iterations=lin_iters,
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


# tier -> (jt step, flat step)
_STEP_OPS = {"schur_dense": (DenseSchurStepOps, FlatDenseSchurStepOps),
             "schur_iterative": (IterativeSchurStepOps, FlatIterativeSchurStepOps)}


def build_fused_minimizer(program, options: Options, tier: str, e_families=None):
    """Factory for the fused minimizer of a linear-solver tier, the dense-
    or the iterative-Schur one: its jt step for a program the jt path
    takes, its flat step for any other."""
    if tier not in _STEP_OPS:
        raise NotImplementedError(f"fused tier {tier!r} is not ported")
    jt_ops, flat_ops = _STEP_OPS[tier]
    pm = pt.build_partition(bsr.build_meta(program), e_families)
    cls = jt_ops if fo.jt_refusal(pm, program) is None else flat_ops
    return FusedTrustRegionMinimizer(program, options, cls(program, options, e_families))
