"""Bundle-adjustment LM steps over plain tensors on one device
(counterpart of the single-device half of ceres_tpu/parallel/sharded_ba.py).

Self-contained over cams (C, 9), pts (P, 3) and the observation rows
(camera index, point index, pixel), the shape the compiled program lowers
BA problems to; the JAX package runs these steps as its specialized
benchmark pipeline (bench.py:131, `lm_step_schur_k` with k = 20 on BAL-16):

 - `lm_step_schur` (v1): one exact dense-Schur LM iteration. The points are
   eliminated in closed form (3x3 per point), the reduced camera system S
   (9C x 9C) is assembled explicitly and Cholesky-solved. `lm_step_schur_k`
   runs k of them with the evaluation carried across iterations.
 - `lm_step_schur_v2_k` (v2): the same math through the one-kernel Schur
   assembly (ops/kernels.schur_assembly) over the transposed J (24, B).
 - `lm_step` (CGNR with an in-step CG) and `solve_ba` without a mesh.

A k-call is a Python loop of device work with no host sync inside it: the
accept test and the radius update stay 0-d tensors under torch.where, as
in the JAX fori_loop, and a failed Cholesky factor comes out NaN, which
rejects the step. The caller syncs once, reading the cost.

With a plan over point-sorted rows (`build_point_plan`, the JAX
`pallas_plan`), the point sums, gathers and the A spread with the camera
Gram blocks run as kernels 6, 7 and 8J (ops/kernels.py); without one they
are the plain index_add / index_select of the JAX scatter path. The camera
sums stay one-hot products, as in JAX (C is small here: "auto" takes this
step up to 128 cameras). The JAX module's 0/1 selector matmuls are an MXU
layout device; the same sums are reshapes and elementwise products here.
The mesh half of the JAX module (make_mesh, the sharded steps, the point-,
camera- and halo-sharded pipelines) is ROADMAP.md port slice 9.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.bal import snavely_reprojection_residual
from ..ops import flatops as fo
from ..ops import kernels as kn
from ..program import resolve_device
from ..solvers.linear.dense import cholesky_lower, tri_inverse_lower
from ..types import not_ported

# Run the 9C x 9C solve inside lm_step_schur in float64, as the JAX
# module's flag (sharded_ba.py:170), read at call time. Off by default: in
# float32 the explicit L^{-1} solve then stalls BAL-16 at 2% above the
# float64 cost, as it does in the JAX package. The per-point 3x3 solves
# always run in float64, as the JAX module's PRECISE_POINT_SOLVES (:169,
# never set otherwise) has them: cancellation in float32 costs step quality.
PRECISE_SCHUR_SOLVE = False

_R, _TC, _TP = 2, 9, 3


class BAState(NamedTuple):
    cams: torch.Tensor  # (C, 9)
    pts: torch.Tensor  # (P, 3)
    radius: torch.Tensor  # 0-d trust region radius
    cost: torch.Tensor  # 0-d


class PointPlan(NamedTuple):
    """The kernel plan over point-sorted rows, in place of the JAX
    `pallas_plan = (tile_starts, max_rows)` of plan_block_tiles and of the
    v2 `AsmPlan`. `rows` holds the point segments `pt_start` (the JAX
    tile_starts/max_rows windows of kernels 6-8), the point blocks and the
    runs of one camera within a tile with their camera levels (8J's F'F;
    the JAX kernel accumulates it across its sequential grid) and, for v2, the
    point-pair plan of the Schur assembly (the JAX row_ts/row_tb/ids_T);
    `seg` is kernel 6's segment plan over the P points."""

    rows: fo.RowPlan
    seg: fo.SegmentPlan


# --------------------------------------------------------------------------
# Arrays in, tensors out
# --------------------------------------------------------------------------


def state_from_arrays(cams, pts, radius, dtype, device=None) -> BAState:
    """A BAState from numpy arrays (or anything torch.as_tensor takes): the
    radius a 0-d tensor of `dtype`, the cost 0. On the card unless
    device="cpu"."""
    dev = resolve_device(device)
    return BAState(torch.as_tensor(np.asarray(cams), dtype=dtype, device=dev),
                   torch.as_tensor(np.asarray(pts), dtype=dtype, device=dev),
                   torch.tensor(float(radius), dtype=dtype, device=dev),
                   torch.zeros((), dtype=dtype, device=dev))


def observations_by_point(camera_index, point_index, observations, dtype,
                          device=None):
    """(cam_idx (B,) int32, pt_idx (B,) int32, obs (B, 2)) with the rows in
    a stable order by point, as the plan and bench.py:136-146 take them."""
    dev = resolve_device(device)
    order = np.argsort(np.asarray(point_index), kind="stable")

    def ids(a):
        return torch.as_tensor(np.asarray(a)[order].astype(np.int32), device=dev)

    obs = torch.as_tensor(np.asarray(observations)[order], dtype=dtype, device=dev)
    return ids(camera_index), ids(point_index), obs


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def build_point_plan(cam_idx, pt_idx, P: int, C: int, device=None) -> PointPlan:
    """The plan of kernels 6, 7 and 8J over rows sorted by point; on the
    card unless device="cpu"."""
    dev = resolve_device(device)
    ci, pi = _host(cam_idx), _host(pt_idx)
    return PointPlan(fo.build_row_plan(pi, ci, P, C, dev),
                     fo.build_segment_plan(pi, P, dev))


def build_asm_plan(cam_idx, pt_idx, P: int, C: int, device=None) -> PointPlan:
    """The v2 plan (sharded_ba.py:813): the point plan with the point-pair
    plan of the Schur assembly built."""
    plan = build_point_plan(cam_idx, pt_idx, P, C, device)
    plan.rows.ensure_pairs()
    return plan


# --------------------------------------------------------------------------
# Evaluation
# --------------------------------------------------------------------------


def _residual_and_blocks(cam, pt, ob):
    """Residual (2,) and Jacobian blocks (2, 9), (2, 3) of one observation
    by forward-mode AD, in the residual's dtype (forward mode promotes a
    float32 tangent times a Python float to float64)."""
    def f(c, p):
        r = snavely_reprojection_residual(c, p, ob)
        return r, r

    (Jc, Jp), r = torch.func.jacfwd(f, argnums=(0, 1), has_aux=True)(cam, pt)
    return r, Jc.to(r.dtype), Jp.to(r.dtype)


_eval_rows = torch.func.vmap(_residual_and_blocks)
_eval_rows_T = torch.func.vmap(_residual_and_blocks, in_dims=(0, 0, 1))
_residual_rows = torch.func.vmap(snavely_reprojection_residual)


def _gather_cams(cams, cam_idx):
    return cams.index_select(0, cam_idx)


def ba_cost(cams, pts, cam_idx, pt_idx, obs, w=None):
    r = _residual_rows(_gather_cams(cams, cam_idx.long()),
                       pts.index_select(0, pt_idx.long()), obs)
    if w is not None:
        r = r * w[:, None]
    return 0.5 * torch.sum(r * r)


def _evaluate(cams, pts, cam_idx, pt_idx, obs, w=None):
    """Residuals and per-row Jacobian blocks; `w` a 0/1 mask of padding
    rows, which then add nothing."""
    r, Jc, Jp = _eval_rows(_gather_cams(cams, cam_idx), pts.index_select(0, pt_idx),
                           obs)
    if w is not None:
        r = r * w[:, None]
        Jc = Jc * w[:, None, None]
        Jp = Jp * w[:, None, None]
    return r, Jc, Jp


def _evaluate_flat(cams, pts, cam_idx, obs, w, expand_p):
    """(r (B, 2), J (B, 24)): J's lanes are J_c (2 x 9) then J_p (2 x 3),
    row-major, as sharded_ba.py:415 lays them out."""
    r, Jc, Jp = _eval_rows(_gather_cams(cams, cam_idx), expand_p(pts), obs)
    B = r.shape[0]
    J = torch.cat([Jc.reshape(B, _R * _TC), Jp.reshape(B, _R * _TP)], dim=1)
    if w is not None:
        r = r * w[:, None]
        J = J * w[:, None]
    return r, J


# --------------------------------------------------------------------------
# Small-block algebra (the JAX selector matmuls, sharded_ba.py:147-255)
# --------------------------------------------------------------------------


def _outer_flat(A, B, r, ta, tb):
    """sum over r of outer(A_r, B_r) on flat rows: A (N, r*ta), B (N, r*tb)
    -> (N, ta*tb), out[i*tb + j] = sum_q A[q*ta + i] B[q*tb + j]."""
    N = A.shape[0]
    return torch.sum(A.reshape(N, r, ta, 1) * B.reshape(N, r, 1, tb), dim=1).reshape(
        N, ta * tb)


def _chol3_flat(m):
    """Closed-form Cholesky of symmetric 3x3 blocks (N, 9) row-major ->
    the lanes (L11, L21, L31, L22, L32, L33)."""
    a, b, c = m[:, 0], m[:, 1], m[:, 2]
    d, e, f = m[:, 4], m[:, 5], m[:, 8]
    L11 = torch.sqrt(a)
    L21 = b / L11
    L31 = c / L11
    L22 = torch.sqrt(d - L21 * L21)
    L32 = (e - L21 * L31) / L22
    L33 = torch.sqrt(f - L31 * L31 - L32 * L32)
    return L11, L21, L31, L22, L32, L33


def _inv_lower3(L):
    """K = L^{-1} of lower-triangular 3x3 lanes -> (N, 9) row-major."""
    L11, L21, L31, L22, L32, L33 = L
    K11 = 1.0 / L11
    K22 = 1.0 / L22
    K33 = 1.0 / L33
    K21 = -L21 * K11 * K22
    K31 = (L21 * L32 - L31 * L22) * K11 * K22 * K33
    K32 = -L32 * K22 * K33
    z = torch.zeros_like(K11)
    return torch.stack([K11, z, z, K21, K22, z, K31, K32, K33], dim=1)


def _solve_lower3_t(L, v):
    """x = L^{-T} v for lower-triangular 3x3 lanes, v (N, 3)."""
    L11, L21, L31, L22, L32, L33 = L
    x3 = v[:, 2] / L33
    x2 = (v[:, 1] - L32 * x3) / L22
    x1 = (v[:, 0] - L21 * x2 - L31 * x3) / L11
    return torch.stack([x1, x2, x3], dim=1)


def _apply3(K, v):
    """Blockwise K v: K (N, 9) row-major blocks, v (N, 3)."""
    return torch.sum(K.reshape(-1, _TP, _TP) * v[:, None, :], dim=2)


def _make_reducers(cam_idx, pt_idx, C, P):
    """(camera sum, point sum) of (B, k) rows: index_add. The JAX module's
    SortedSegments (sharded_ba.py:61), a permutation to sorted ids ahead of
    a sorted segment sum on the TPU, would be an index_select ahead of the
    same index_add here, and is left out."""
    def rc(contrib):
        return contrib.new_zeros((C, contrib.shape[1])).index_add_(0, cam_idx, contrib)

    def rp(contrib):
        return contrib.new_zeros((P, contrib.shape[1])).index_add_(0, pt_idx, contrib)
    return rc, rp


# --------------------------------------------------------------------------
# CGNR step (sharded_ba.py:258)
# --------------------------------------------------------------------------


def _accept(cost, new_cost, mcc, radius, finite_check):
    """The LM acceptance and radius rules of the JAX steps."""
    rel = (cost - new_cost) / torch.clamp(mcc, min=1e-300)
    ok = mcc > 0
    if finite_check:
        ok = ok & torch.isfinite(new_cost)
    accept = ok & (rel > 1e-3)
    grown = torch.clamp(radius / torch.clamp(1.0 - (2.0 * rel - 1.0) ** 3,
                                             min=1.0 / 3.0), max=1e16)
    return accept, torch.where(accept, grown, radius / 2.0)


def lm_step(cams, pts, cam_idx, pt_idx, obs, radius, w=None, cg_iters: int = 10):
    """One LM iteration: evaluate, Jacobi-preconditioned CG (cg_iters
    iterations, no early exit) on the scaled normal equations, candidate,
    accept or reject, radius update. Returns a BAState."""
    ci, pi = cam_idx.long(), pt_idx.long()
    C, P = cams.shape[0], pts.shape[0]
    r, Jc, Jp = _evaluate(cams, pts, ci, pi, obs, w)
    cost = 0.5 * torch.sum(r * r)
    reduce_c, reduce_p = _make_reducers(ci, pi, C, P)

    # gradient and column norms: 4 reductions, the scaled forms follow
    # elementwise (col(Js)^2 = s^2 col(J)^2, Js'r = s J'r)
    gc = reduce_c(torch.sum(Jc * r[:, :, None], dim=1))
    gp = reduce_p(torch.sum(Jp * r[:, :, None], dim=1))
    d2c = reduce_c(torch.sum(Jc * Jc, dim=1))
    d2p = reduce_p(torch.sum(Jp * Jp, dim=1))
    sc = 1.0 / (1.0 + torch.sqrt(d2c))
    sp = 1.0 / (1.0 + torch.sqrt(d2p))
    Jsc = Jc * sc[ci][:, None, :]
    Jsp = Jp * sp[pi][:, None, :]
    diag_c = torch.clamp(sc * sc * d2c, 1e-6, 1e32)
    diag_p = torch.clamp(sp * sp * d2p, 1e-6, 1e32)
    D2c = diag_c / radius
    D2p = diag_p / radius
    rhs_c = sc * gc
    rhs_p = sp * gp
    Minv_c = 1.0 / (diag_c + D2c)
    Minv_p = 1.0 / (diag_p + D2p)

    def jmul(vc, vp):
        return torch.sum(Jsc * vc[ci][:, None, :], dim=2) + torch.sum(
            Jsp * vp[pi][:, None, :], dim=2)

    def matvec(vc, vp):
        jv = jmul(vc, vp)
        return (reduce_c(torch.sum(Jsc * jv[:, :, None], dim=1)) + D2c * vc,
                reduce_p(torch.sum(Jsp * jv[:, :, None], dim=1)) + D2p * vp)

    xc, xp = torch.zeros_like(cams), torch.zeros_like(pts)
    rc, rp = rhs_c, rhs_p
    pc, pp = Minv_c * rhs_c, Minv_p * rhs_p
    rz = torch.sum(rhs_c * pc) + torch.sum(rhs_p * pp)
    for _ in range(cg_iters):
        qc, qp = matvec(pc, pp)
        pq = torch.sum(pc * qc) + torch.sum(pp * qp)
        alpha = rz / torch.clamp(pq, min=1e-300)
        xc = xc + alpha * pc
        xp = xp + alpha * pp
        rc = rc - alpha * qc
        rp = rp - alpha * qp
        zc = Minv_c * rc
        zp = Minv_p * rp
        rz_new = torch.sum(rc * zc) + torch.sum(rp * zp)
        beta = rz_new / torch.clamp(rz, min=1e-300)
        pc = zc + beta * pc
        pp = zp + beta * pp
        rz = rz_new
    step_c, step_p = -xc, -xp

    # model cost change in scaled coordinates
    jstep = jmul(step_c, step_p)
    mcc = -torch.sum(jstep * (r + jstep / 2.0))
    new_cams = cams + step_c * sc
    new_pts = pts + step_p * sp
    new_cost = ba_cost(new_cams, new_pts, ci, pi, obs, w)
    accept, radius_out = _accept(cost, new_cost, mcc, radius, finite_check=False)
    return BAState(torch.where(accept, new_cams, cams), torch.where(accept, new_pts, pts),
                   radius_out, torch.where(accept, new_cost, cost))


# --------------------------------------------------------------------------
# Exact dense-Schur step, v1 (sharded_ba.py:370-752)
# --------------------------------------------------------------------------


class _Env(NamedTuple):
    """What every iteration of one call shares: the row -> camera and
    point maps, the camera one-hot of the camera sums (masked by w), and
    the point operations."""

    ci: torch.Tensor  # (B,) int64 camera of each row
    ci32: torch.Tensor  # (B,) int32, for the spread kernel
    onehot: torch.Tensor  # (B, C), rows scaled by w
    reduce_p: object
    expand_p: object
    spread_p: object


def _point_ops(pt_idx, P, plan: Optional[PointPlan]):
    """(reduce_p, expand_p, spread_p): with a plan over point-sorted rows,
    kernels 6, 7 and 8J (sharded_ba.py:370); without one, index_add and
    index_select, and no spread (the A spread is then a point reduction of
    the spread rows)."""
    if plan is None:
        pi = pt_idx.long()

        def reduce_p(contrib):
            return contrib.new_zeros((P, contrib.shape[1])).index_add_(0, pi, contrib)

        def expand_p(vals):
            return vals.index_select(0, pi)

        return reduce_p, expand_p, None

    def reduce_p(contrib):  # (B, k) -> (P, k)
        return kn.segment_block_sum(contrib.contiguous(), plan.seg)

    def expand_p(vals):  # (P, k) -> (B, k)
        return kn.segment_block_expand(vals.contiguous(), plan.rows.pt_idx)

    def spread_p(Y, cam_ids, C, tp, tc, Jc):  # A (P, tp*C*tc), F'F (C, tc*tc)
        return kn.segment_spread_ftf(Y.contiguous(), cam_ids, plan.rows.pt_start, C,
                                     tp, tc, Jc.contiguous(), _R, plan.rows)

    return reduce_p, expand_p, spread_p


def _env(cams, cam_idx, pt_idx, P, w, plan) -> _Env:
    C = cams.shape[0]
    ci = cam_idx.long()
    onehot = torch.nn.functional.one_hot(ci, C).to(cams.dtype)
    if w is not None:
        # padding rows vanish from the camera sums; gathers read the
        # unmasked ids, so padded rows still see real cameras
        onehot = onehot * w[:, None]
    return _Env(ci, cam_idx.to(torch.int32).contiguous(), onehot,
                *_point_ops(pt_idx, P, plan))


def _camera_sum(env: _Env, contrib):
    """(B, k) -> (C, k) through the camera one-hot, as sharded_ba.py:479."""
    return env.onehot.T @ contrib


def _point_blocks(ete_u, sp, D2p, gp):
    """The per-point elimination (sharded_ba.py:508-523): M = sp sp' (.)
    E'E + D_p^2, its Cholesky lanes L3 and K = L^{-1} in float64, and E'r
    scaled, etb = sp g_p."""
    P = ete_u.shape[0]
    M = ete_u * _outer_flat(sp, sp, 1, _TP, _TP) + torch.diag_embed(D2p).reshape(
        P, _TP * _TP)
    L3 = _chol3_flat(M.double())
    return L3, _inv_lower3(L3), sp * gp


def _reduced_solve(S, rhs, dt):
    """z = S^{-1} rhs in the precision of PRECISE_SCHUR_SOLVE
    (sharded_ba.py:577-588): float64 Cholesky solve, or in float32 the
    explicit L^{-1} of the factor applied twice, no refinement."""
    dtS = torch.float64 if PRECISE_SCHUR_SOLVE else dt
    Ls = cholesky_lower(S.to(dtS))
    b = rhs.to(dtS)[:, None]
    if dtS == torch.float32:
        Linv = tri_inverse_lower(Ls)
        z = Linv.T @ (Linv @ b)
    else:
        y = torch.linalg.solve_triangular(Ls, b, upper=False)
        z = torch.linalg.solve_triangular(Ls.T, y, upper=True)
    return z[:, 0].to(dt)


def _camera_system(FtF, AtA, D2c):
    """S = blockdiag(F'F) - A'A + diag(D_c^2), FtF (C, 9, 9)."""
    C = FtF.shape[0]
    eye = torch.eye(C, dtype=FtF.dtype, device=FtF.device)
    S = torch.einsum("cij,cd->cidj", FtF, eye).reshape(C * _TC, C * _TC)
    return S - AtA + torch.diag(D2c.reshape(-1))


def _model_cost_change(sc, gc, sp, gp, D2c, D2p, step_c, step_p):
    """Exact-solve identity: with (J_s'J_s + D^2) d = -g_s,
    -m(d) = -1/2 g_s'd + 1/2 d'D^2 d (reduced-space dot products)."""
    g_dot = torch.sum((sc * gc) * step_c) + torch.sum((sp * gp) * step_p)
    d2_dot = torch.sum(D2c * step_c * step_c) + torch.sum(D2p * step_p * step_p)
    return -0.5 * g_dot + 0.5 * d2_dot


def _schur_core(J, r, radius, env: _Env, C, P, w=None):
    """Exact dense-Schur LM step from a flat evaluation (sharded_ba.py:460):
    (step_c, step_p, sc, sp, model_cost_change)."""
    B = r.shape[0]
    dt = J.dtype
    Jc = J[:, :_R * _TC].reshape(B, _R, _TC)
    Jp = J[:, _R * _TC:].reshape(B, _R, _TP)

    # ONE point reduction of the unscaled E'r, diag and E'E rows (the
    # point scale is a per-point constant, so it commutes with the sum)
    jtr_p = torch.sum(Jp * r[:, :, None], dim=1)
    jsq_p = torch.sum(Jp * Jp, dim=1)
    J_p = J[:, _R * _TC:]
    red = env.reduce_p(torch.cat([jtr_p, jsq_p, _outer_flat(J_p, J_p, _R, _TP, _TP)],
                                 dim=1))
    gp, d2p, ete_u = red[:, :_TP], red[:, _TP:2 * _TP], red[:, 2 * _TP:]
    gc_d2c = _camera_sum(env, torch.cat([torch.sum(Jc * r[:, :, None], dim=1),
                                         torch.sum(Jc * Jc, dim=1)], dim=1))
    gc, d2c = gc_d2c[:, :_TC], gc_d2c[:, _TC:]
    sc = 1.0 / (1.0 + torch.sqrt(d2c))
    sp = 1.0 / (1.0 + torch.sqrt(d2p))
    D2c = torch.clamp(sc * sc * d2c, 1e-6, 1e32) / radius
    D2p = torch.clamp(sp * sp * d2p, 1e-6, 1e32) / radius

    L3, K64, etb = _point_blocks(ete_u, sp, D2p, gp)
    Kf = K64.to(dt)

    # ONE point gather of [K (9), sp (3)] for every row
    exp = env.expand_p(torch.cat([Kf, sp], dim=1))
    Kf_g, sp_g = exp[:, :_TP * _TP], exp[:, _TP * _TP:]
    Js_c = (Jc * _gather_cams(sc, env.ci)[:, None, :]).reshape(B, _R * _TC)
    Js_p = (Jp * sp_g[:, None, :]).reshape(B, _R * _TP)

    # A = L^{-1} W' stacked per point: rows 3p+i, columns 9c+j
    W = _outer_flat(Js_p, Js_c, _R, _TP, _TC)  # (B, 27)
    Y = fo.small_matmul(Kf_g.reshape(B, _TP, _TP), W.reshape(B, _TP, _TC)).reshape(
        B, _TP * _TC)
    if env.spread_p is not None:
        # kernel 8J: the spread and its point sums with the camera Gram
        # blocks, no (B, 3*C*9) spread or (B, 81) outer products
        Yk = Y if w is None else Y * w[:, None]
        Jck = Js_c if w is None else Js_c * w[:, None]
        A, ftf = env.spread_p(Yk, env.ci32, C, _TP, _TC, Jck)
        A = A.reshape(P * _TP, C * _TC)
        FtF = ftf.reshape(C, _TC, _TC)
    else:
        T = (Y.reshape(B, _TP, 1, _TC) * env.onehot[:, None, :, None]).reshape(
            B, _TP * C * _TC)
        A = env.reduce_p(T).reshape(P * _TP, C * _TC)
        FtF = _camera_sum(env, _outer_flat(Js_c, Js_c, _R, _TC, _TC)).reshape(
            C, _TC, _TC)
    S = _camera_system(FtF, A.T @ A, D2c)
    u = _apply3(K64, etb.double()).to(dt)  # L^{-1} etb
    rhs = (sc * gc).reshape(-1) - A.T @ u.reshape(-1)
    z = _reduced_solve(S, rhs, dt)

    # back substitution: y_p = L^{-T} (u_p - A_p z)
    Az = (A @ z).reshape(P, _TP)
    y_p = _solve_lower3_t(L3, (u - Az).double()).to(dt)
    step_c = -z.reshape(C, _TC)
    step_p = -y_p
    mcc = _model_cost_change(sc, gc, sp, gp, D2c, D2p, step_c, step_p)
    return step_c, step_p, sc, sp, mcc


def lm_step_schur(cams, pts, cam_idx, pt_idx, obs, radius, w=None,
                  plan: Optional[PointPlan] = None):
    """One LM iteration with the exact dense-Schur step (sharded_ba.py:608):
    eliminate the points (E'E + D^2 is 3x3 block diagonal), assemble the
    reduced camera system S explicitly, Cholesky-solve it. `plan` (from
    build_point_plan over point-sorted rows) runs the point sums, gathers
    and the A spread as kernels 6, 7 and 8J. Returns a BAState."""
    C, P = cams.shape[0], pts.shape[0]
    env = _env(cams, cam_idx, pt_idx, P, w, plan)
    r, J = _evaluate_flat(cams, pts, env.ci, obs, w, env.expand_p)
    cost = 0.5 * torch.sum(r * r)
    step_c, step_p, sc, sp, mcc = _schur_core(J, r, radius, env, C, P, w)
    new_cams = cams + step_c * sc
    new_pts = pts + step_p * sp
    r_new = _residual_rows(_gather_cams(new_cams, env.ci), env.expand_p(new_pts), obs)
    if w is not None:
        r_new = r_new * w[:, None]
    new_cost = 0.5 * torch.sum(r_new * r_new)
    accept, radius_out = _accept(cost, new_cost, mcc, radius, finite_check=True)
    return BAState(torch.where(accept, new_cams, cams), torch.where(accept, new_pts, pts),
                   radius_out, torch.where(accept, new_cost, cost))


class SchurCarry(NamedTuple):
    """BAState and the (r, J) evaluation at (cams, pts): an accepted
    candidate's evaluation is the next iteration's, so each iteration
    evaluates once."""

    cams: torch.Tensor
    pts: torch.Tensor
    radius: torch.Tensor
    cost: torch.Tensor
    r: torch.Tensor
    J: torch.Tensor


def _init(cams, pts, obs, radius, w, env: _Env) -> SchurCarry:
    r, J = _evaluate_flat(cams, pts, env.ci, obs, w, env.expand_p)
    return SchurCarry(cams, pts, radius, 0.5 * torch.sum(r * r), r, J)


def _next(carry: SchurCarry, obs, w, env: _Env) -> SchurCarry:
    cams, pts, radius, cost, r, J = carry
    C, P = cams.shape[0], pts.shape[0]
    step_c, step_p, sc, sp, mcc = _schur_core(J, r, radius, env, C, P, w)
    new_cams = cams + step_c * sc
    new_pts = pts + step_p * sp
    r_new, J_new = _evaluate_flat(new_cams, new_pts, env.ci, obs, w, env.expand_p)
    new_cost = 0.5 * torch.sum(r_new * r_new)
    accept, radius_out = _accept(cost, new_cost, mcc, radius, finite_check=True)
    return SchurCarry(torch.where(accept, new_cams, cams),
                      torch.where(accept, new_pts, pts), radius_out,
                      torch.where(accept, new_cost, cost),
                      torch.where(accept, r_new, r), torch.where(accept, J_new, J))


def lm_step_schur_init(cams, pts, cam_idx, pt_idx, obs, radius, w=None,
                       plan: Optional[PointPlan] = None) -> SchurCarry:
    return _init(cams, pts, obs, radius, w,
                 _env(cams, cam_idx, pt_idx, pts.shape[0], w, plan))


def lm_step_schur_next(carry: SchurCarry, cam_idx, pt_idx, obs, w=None,
                       plan: Optional[PointPlan] = None) -> SchurCarry:
    """lm_step_schur with the evaluation carried across iterations."""
    return _next(carry, obs, w,
                 _env(carry.cams, cam_idx, pt_idx, carry.pts.shape[0], w, plan))


def lm_step_schur_k(cams, pts, cam_idx, pt_idx, obs, radius, k=5, w=None,
                    plan: Optional[PointPlan] = None) -> BAState:
    """k LM iterations with the evaluation carry (sharded_ba.py:737): one
    evaluation per iteration, no host sync inside. Returns the BAState
    after k iterations."""
    env = _env(cams, cam_idx, pt_idx, pts.shape[0], w, plan)
    carry = _init(cams, pts, obs, radius, w, env)
    for _ in range(k):
        carry = _next(carry, obs, w, env)
    return BAState(carry.cams, carry.pts, carry.radius, carry.cost)


# --------------------------------------------------------------------------
# v2: the same step through the one-kernel Schur assembly
# (sharded_ba.py:755-1034). The JAX evaluation groups J into 48 padded,
# 8-aligned lanes for the TPU; here it is the kernels' JT (24, B).
# --------------------------------------------------------------------------


class SchurCarryT(NamedTuple):
    """BAState and the transposed evaluation rT (2, B), JT (24, B)."""

    cams: torch.Tensor
    pts: torch.Tensor
    radius: torch.Tensor
    cost: torch.Tensor
    r_T: torch.Tensor
    J_T: torch.Tensor


def _evaluate_T(cams, pts, env: _Env, obs_T):
    """(rT (2, B), JT (24, B)) from obs_T (2, B); the point rows through
    kernel 7 (sharded_ba.py:789)."""
    r, Jc, Jp = _eval_rows_T(_gather_cams(cams, env.ci), env.expand_p(pts), obs_T)
    B = r.shape[0]
    J = torch.cat([Jc.reshape(B, _R * _TC), Jp.reshape(B, _R * _TP)], dim=1)
    return r.T.contiguous(), J.T.contiguous()


def _schur_core_asm(JT, rT, radius, env: _Env, plan: PointPlan, C, P):
    """_schur_core's step through kernel 3 (sharded_ba.py:834): its two
    point sums through kernel 6, the back substitution through the
    implicit identity A_p z = K_p (E_s'F_s z)_p."""
    dt = JT.dtype
    B = rT.shape[1]
    Jf = JT[:_R * _TC].reshape(_R, _TC, B)
    Je = JT[_R * _TC:].reshape(_R, _TP, B)

    # fused point sum: [E'r (3) | diag E'E (3) | E'E (9)]
    jtr_e = torch.sum(Je * rT[:, None, :], dim=0)
    jsq_e = torch.sum(Je * Je, dim=0)
    outer_e = torch.sum(Je[:, :, None, :] * Je[:, None, :, :], dim=0).reshape(
        _TP * _TP, B)
    red = env.reduce_p(torch.cat([jtr_e, jsq_e, outer_e], dim=0).T)
    gp, d2p, ete_u = red[:, :_TP], red[:, _TP:2 * _TP], red[:, 2 * _TP:]
    gc = _camera_sum(env, torch.sum(Jf * rT[:, None, :], dim=0).T)
    d2c = _camera_sum(env, torch.sum(Jf * Jf, dim=0).T)
    sc = 1.0 / (1.0 + torch.sqrt(d2c))
    sp = 1.0 / (1.0 + torch.sqrt(d2p))
    D2c = torch.clamp(sc * sc * d2c, 1e-6, 1e32) / radius
    D2p = torch.clamp(sp * sp * d2p, 1e-6, 1e32) / radius

    L3, K64, etb = _point_blocks(ete_u, sp, D2p, gp)
    u64 = _apply3(K64, etb.double())
    ata, ftf, U = kn.schur_assembly(JT, sc.contiguous(), sp.contiguous(),
                                    K64.to(dt).contiguous(), u64.to(dt).contiguous(),
                                    plan.rows)
    S = _camera_system(ftf.reshape(C, _TC, _TC), ata, D2c)
    z = _reduced_solve(S, (sc * gc).reshape(-1) - U, dt)

    # back substitution: E_s'F_s z per point, then K and L^{-T}
    zg = _gather_cams(sc * z.reshape(C, _TC), env.ci).T  # (9, B)
    fz = torch.sum(Jf * zg[None, :, :], dim=1)  # (2, B)
    contrib = torch.sum(Je * fz[:, None, :], dim=0)  # (3, B)
    etfz = sp * env.reduce_p(contrib.T)
    Az64 = _apply3(K64, etfz.double())
    y_p = _solve_lower3_t(L3, u64 - Az64).to(dt)
    step_c = -z.reshape(C, _TC)
    step_p = -y_p
    mcc = _model_cost_change(sc, gc, sp, gp, D2c, D2p, step_c, step_p)
    return step_c, step_p, sc, sp, mcc


def _init_v2(cams, pts, obs_T, radius, env: _Env) -> SchurCarryT:
    rT, JT = _evaluate_T(cams, pts, env, obs_T)
    return SchurCarryT(cams, pts, radius, 0.5 * torch.sum(rT * rT), rT, JT)


def _next_v2(carry: SchurCarryT, obs_T, env: _Env, plan: PointPlan) -> SchurCarryT:
    cams, pts, radius, cost, rT, JT = carry
    C, P = cams.shape[0], pts.shape[0]
    step_c, step_p, sc, sp, mcc = _schur_core_asm(JT, rT, radius, env, plan, C, P)
    new_cams = cams + step_c * sc
    new_pts = pts + step_p * sp
    r_new, J_new = _evaluate_T(new_cams, new_pts, env, obs_T)
    new_cost = 0.5 * torch.sum(r_new * r_new)
    accept, radius_out = _accept(cost, new_cost, mcc, radius, finite_check=True)
    return SchurCarryT(torch.where(accept, new_cams, cams),
                       torch.where(accept, new_pts, pts), radius_out,
                       torch.where(accept, new_cost, cost),
                       torch.where(accept, r_new, rT), torch.where(accept, J_new, JT))


def _env_v2(cams, cam_idx, pt_idx, plan: PointPlan) -> _Env:
    if plan is None:
        raise ValueError("the v2 pipeline needs a plan (build_asm_plan)")
    return _env(cams, cam_idx, pt_idx, plan.rows.P, None, plan)


def lm_step_schur_v2_init(cams, pts, cam_idx, pt_idx, obs_T, radius,
                          plan: PointPlan) -> SchurCarryT:
    return _init_v2(cams, pts, obs_T, radius, _env_v2(cams, cam_idx, pt_idx, plan))


def lm_step_schur_v2_next(carry: SchurCarryT, cam_idx, pt_idx, obs_T,
                          plan: PointPlan) -> SchurCarryT:
    return _next_v2(carry, obs_T, _env_v2(carry.cams, cam_idx, pt_idx, plan), plan)


def lm_step_schur_v2_k(cams, pts, cam_idx, pt_idx, obs_T, radius, plan: PointPlan,
                       k=5) -> BAState:
    """k LM iterations through the one-kernel assembly (sharded_ba.py:1022);
    obs_T (2, B), rows sorted by point, `plan` from build_asm_plan."""
    env = _env_v2(cams, cam_idx, pt_idx, plan)
    carry = _init_v2(cams, pts, obs_T, radius, env)
    for _ in range(k):
        carry = _next_v2(carry, obs_T, env, plan)
    return BAState(carry.cams, carry.pts, carry.radius, carry.cost)


# --------------------------------------------------------------------------
# solve_ba (sharded_ba.py:1073)
# --------------------------------------------------------------------------


def solve_ba(bal_problem, num_iterations=10, mesh=None, cg_iters=10,
             dtype=torch.float64, step="auto", device=None) -> BAState:
    """Run `num_iterations` LM steps on a BALProblem; returns the final
    BAState. step: "schur" (lm_step_schur), "cg" (lm_step), "auto" (schur
    up to 128 cameras). On the card unless device="cpu"; a mesh is
    multi-device work (ROADMAP.md port slice 9)."""
    if mesh is not None:
        raise not_ported("solve_ba over a mesh", 9)
    dev = resolve_device(device)
    state = state_from_arrays(bal_problem.cameras, bal_problem.points, 1e4, dtype, dev)
    cam_idx = torch.as_tensor(np.asarray(bal_problem.camera_index, np.int64), device=dev)
    pt_idx = torch.as_tensor(np.asarray(bal_problem.point_index, np.int64), device=dev)
    obs = torch.as_tensor(np.asarray(bal_problem.observations), dtype=dtype, device=dev)
    use_schur = step == "schur" or (step == "auto" and bal_problem.cameras.shape[0] <= 128)
    for _ in range(num_iterations):
        if use_schur:
            state = lm_step_schur(state.cams, state.pts, cam_idx, pt_idx, obs,
                                  state.radius)
        else:
            state = lm_step(state.cams, state.pts, cam_idx, pt_idx, obs, state.radius,
                            cg_iters=cg_iters)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return state
