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
Sums by id outside the plans go through program.scatter_add_rows, which
adds in the same order on every call (index_add_ on a card adds by
atomics, whose order changes from run to run).

The mesh half (sharded_ba.py:1037-2216) runs over torch.distributed, one
process per rank (parallel/mesh.py): every psum, tiled all-gather, tiled
all-to-all and axis_index of the JAX code is a call on the rank's `Mesh`.

 - `solve_ba(mesh=...)`: the observations sharded, the state replicated
   (the JAX GSPMD step): the point and camera sums close with a psum each.
 - the point-sharded tier (`solve_ba_point_sharded`): each rank owns a
   contiguous slice of points and exactly their observations, sorted by
   point, with a `PointPlan` of its own rows: its point sums, gathers and
   the A spread run as kernels 6, 7 and 8J, and the camera side (the
   gradient, F'F, A'A, A'u, the model cost) closes with one psum each.
 - the camera-sharded tier (`solve_ba_camera_sharded`): cameras and points
   both partitioned; the points gathered once an iteration, their sums
   closed by psums; or, with `halo`, only the rows each rank's
   observations touch exchanged by two tiled all-to-alls (`_halo_fwd`,
   `_halo_rev`), whose reverse sums into the owner's rows in a fixed
   order.
 - the Ceres-semantics halo tier (`solve_ba_camera_halo_ceres`): the host
   loop's options, step evaluator and termination taxonomy on the halo
   layout; every decision is taken on the host from scalars that came out
   of a collective, so all ranks branch alike.
A tier returns each rank's own shards and the plan;
`mesh.gather_padded` assembles a padded global table on every rank.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.bal import snavely_reprojection_residual
from ..ops import flatops as fo
from ..ops import kernels as kn
from ..program import resolve_device, scatter_add_rows
from ..solvers.linear.dense import cholesky_lower, tri_inverse_lower

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
    return PointPlan(fo.build_row_plan(pi, ci, P, C, dev, n_cams=C),
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


def _sum_by(ids, n, contrib):
    """(n, k) sums of the (B, k) rows by id, in a fixed order."""
    return scatter_add_rows(contrib.new_zeros((n, contrib.shape[1])), ids, contrib)


def _make_reducers(cam_idx, pt_idx, C, P, psum_c=None, psum_p=None):
    """(camera sum, point sum) of (B, k) rows, each closed over the mesh
    by its psum where given. The JAX module's SortedSegments
    (sharded_ba.py:61), a permutation to sorted ids ahead of a sorted
    segment sum on the TPU, is what scatter_add_rows does inside."""
    def rc(contrib):
        out = _sum_by(cam_idx, C, contrib)
        return out if psum_c is None else psum_c(out)

    def rp(contrib):
        out = _sum_by(pt_idx, P, contrib)
        return out if psum_p is None else psum_p(out)
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


def _closer(mesh):
    return (lambda x: x) if mesh is None else mesh.psum


def _cg_fixed(matvec, rhs_c, rhs_p, Minv_c, Minv_p, cg_iters, dots):
    """cg_iters Jacobi-preconditioned CG iterations, no early exit, over a
    (camera, point) pair of vectors; dots(ac, bc, ap, bp) their inner
    product. Returns (xc, xp)."""
    xc, xp = torch.zeros_like(rhs_c), torch.zeros_like(rhs_p)
    rc, rp = rhs_c, rhs_p
    pc, pp = Minv_c * rhs_c, Minv_p * rhs_p
    rz = dots(rhs_c, pc, rhs_p, pp)
    for _ in range(cg_iters):
        qc, qp = matvec(pc, pp)
        alpha = rz / torch.clamp(dots(pc, qc, pp, qp), min=1e-300)
        xc = xc + alpha * pc
        xp = xp + alpha * pp
        rc = rc - alpha * qc
        rp = rp - alpha * qp
        zc = Minv_c * rc
        zp = Minv_p * rp
        rz_new = dots(rc, zc, rp, zp)
        beta = rz_new / torch.clamp(rz, min=1e-300)
        pc = zc + beta * pc
        pp = zp + beta * pp
        rz = rz_new
    return xc, xp


class _Linearization(NamedTuple):
    """The Jacobi-scaled, damped normal equations of one evaluation
    (sharded_ba.py:1390-1431, :1693-1763)."""

    r: torch.Tensor
    cost: torch.Tensor
    Jsc: torch.Tensor  # (B, 2, 9) scaled camera blocks
    Jsp: torch.Tensor  # (B, 2, 3) scaled point blocks
    sc: torch.Tensor
    sp: torch.Tensor
    gc: torch.Tensor
    gp: torch.Tensor
    D2c: torch.Tensor
    D2p: torch.Tensor
    rhs_c: torch.Tensor
    rhs_p: torch.Tensor
    Minv_c: torch.Tensor
    Minv_p: torch.Tensor


def _linearize(r, Jc, Jp, cost, cam_local, reduce_c, reduce_p, expand_sp, radius,
               min_diag=1e-6, max_diag=1e32) -> _Linearization:
    """The gradient and column norms (the camera side by reduce_c, the
    point side by ONE reduce_p), the Jacobi scales, the LM diagonal and
    the preconditioner; expand_sp(sp) gives each row its point's scale."""
    gc = reduce_c(torch.sum(Jc * r[:, :, None], dim=1))
    d2c = reduce_c(torch.sum(Jc * Jc, dim=1))
    tp = Jp.shape[2]
    gd = reduce_p(torch.cat([torch.sum(Jp * r[:, :, None], dim=1),
                             torch.sum(Jp * Jp, dim=1)], dim=1))
    gp, d2p = gd[:, :tp], gd[:, tp:]
    sc = 1.0 / (1.0 + torch.sqrt(d2c))
    sp = 1.0 / (1.0 + torch.sqrt(d2p))
    Jsc = Jc * sc[cam_local][:, None, :]
    Jsp = Jp * expand_sp(sp)[:, None, :]
    diag_c = torch.clamp(sc * sc * d2c, min_diag, max_diag)
    diag_p = torch.clamp(sp * sp * d2p, min_diag, max_diag)
    D2c, D2p = diag_c / radius, diag_p / radius
    return _Linearization(r, cost, Jsc, Jsp, sc, sp, gc, gp, D2c, D2p, sc * gc, sp * gp,
                          1.0 / (diag_c + D2c), 1.0 / (diag_p + D2p))


def _jmul(lin: _Linearization, vc_rows, vp_rows):
    """J_s [vc; vp] per row, from each row's camera and point values."""
    return (torch.sum(lin.Jsc * vc_rows[:, None, :], dim=2)
            + torch.sum(lin.Jsp * vp_rows[:, None, :], dim=2))


def lm_step(cams, pts, cam_idx, pt_idx, obs, radius, w=None, cg_iters: int = 10,
            mesh=None):
    """One LM iteration: evaluate, Jacobi-preconditioned CG (cg_iters
    iterations, no early exit) on the scaled normal equations, candidate,
    accept or reject, radius update. Returns a BAState. With `mesh`, the
    rows are this rank's shard and the state is replicated: the cost,
    the camera and point sums and the model cost change close with a psum
    each (the JAX GSPMD step), and CG's vectors stay replicated."""
    psum = _closer(mesh)
    ci, pi = cam_idx.long(), pt_idx.long()
    C, P = cams.shape[0], pts.shape[0]
    r, Jc, Jp = _evaluate(cams, pts, ci, pi, obs, w)
    cost = psum(0.5 * torch.sum(r * r))
    reduce_c, reduce_p = _make_reducers(ci, pi, C, P, psum, psum)
    lin = _linearize(r, Jc, Jp, cost, ci, reduce_c, reduce_p, lambda sp: sp[pi], radius)

    def matvec(vc, vp):
        jv = _jmul(lin, vc[ci], vp[pi])
        return (reduce_c(torch.sum(lin.Jsc * jv[:, :, None], dim=1)) + lin.D2c * vc,
                reduce_p(torch.sum(lin.Jsp * jv[:, :, None], dim=1)) + lin.D2p * vp)

    xc, xp = _cg_fixed(matvec, lin.rhs_c, lin.rhs_p, lin.Minv_c, lin.Minv_p, cg_iters,
                       lambda ac, bc, ap, bp: torch.sum(ac * bc) + torch.sum(ap * bp))
    step_c, step_p = -xc, -xp

    # model cost change in scaled coordinates
    jstep = _jmul(lin, step_c[ci], step_p[pi])
    mcc = psum(-torch.sum(jstep * (r + jstep / 2.0)))
    new_cams = cams + step_c * lin.sc
    new_pts = pts + step_p * lin.sp
    new_cost = psum(ba_cost(new_cams, new_pts, ci, pi, obs, w))
    accept, radius_out = _accept(cost, new_cost, mcc, radius, finite_check=False)
    return BAState(torch.where(accept, new_cams, cams), torch.where(accept, new_pts, pts),
                   radius_out, torch.where(accept, new_cost, cost))


# --------------------------------------------------------------------------
# Exact dense-Schur step, v1 (sharded_ba.py:370-752)
# --------------------------------------------------------------------------


class _Env(NamedTuple):
    """What every iteration of one call shares: the row -> camera and
    point maps, the camera one-hot of the camera sums (masked by w), the
    point operations, and the mesh closures: psum_c of the cost and the
    camera-side sums, psum_p of the sums over a rank's own points (A'A,
    A'u, the point terms of the model cost) where the points are sharded;
    identities on one device."""

    ci: torch.Tensor  # (B,) int64 camera of each row
    ci32: torch.Tensor  # (B,) int32, for the spread kernel
    onehot: torch.Tensor  # (B, C), rows scaled by w
    reduce_p: object
    expand_p: object
    spread_p: object
    psum_c: object
    psum_p: object


def _point_ops(pt_idx, P, plan: Optional[PointPlan]):
    """(reduce_p, expand_p, spread_p): with a plan over point-sorted rows,
    kernels 6, 7 and 8J (sharded_ba.py:370); without one, a fixed-order
    scatter-add and index_select, and no spread (the A spread is then a
    point reduction of the spread rows)."""
    if plan is None:
        pi = pt_idx.long()

        def reduce_p(contrib):
            return _sum_by(pi, P, contrib)

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


def _env(cams, cam_idx, pt_idx, P, w, plan, mesh=None, points_sharded=False) -> _Env:
    """With `mesh` and not `points_sharded`, the rows are a rank's shard
    with every point replicated (solve_ba's GSPMD step): the point sums
    close with a psum too, and A, S and the back substitution are
    replicated. With `points_sharded` (the point-sharded tier), the rank's
    rows are all the rows of its own points, whose sums stay local."""
    C = cams.shape[0]
    ci = cam_idx.long()
    onehot = torch.nn.functional.one_hot(ci, C).to(cams.dtype)
    if w is not None:
        # padding rows vanish from the camera sums; gathers read the
        # unmasked ids, so padded rows still see real cameras
        onehot = onehot * w[:, None]
    reduce_p, expand_p, spread_p = _point_ops(pt_idx, P, plan)
    psum_c = _closer(mesh)
    psum_p = psum_c if points_sharded else _closer(None)
    if mesh is not None and not points_sharded:
        local_p = reduce_p

        def reduce_p(contrib):
            return mesh.psum(local_p(contrib))
    return _Env(ci, cam_idx.to(torch.int32).contiguous(), onehot, reduce_p, expand_p,
                spread_p, psum_c, psum_p)


def _camera_sum(env: _Env, contrib):
    """(B, k) -> (C, k) through the camera one-hot, as sharded_ba.py:479,
    closed over the mesh."""
    return env.psum_c(env.onehot.T @ contrib)


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


def _model_cost_change(sc, gc, sp, gp, D2c, D2p, step_c, step_p, psum_p=None):
    """Exact-solve identity: with (J_s'J_s + D^2) d = -g_s,
    -m(d) = -1/2 g_s'd + 1/2 d'D^2 d (reduced-space dot products), the
    point terms closed by psum_p where the points are sharded."""
    psum_p = psum_p or (lambda x: x)
    g_dot = torch.sum((sc * gc) * step_c) + psum_p(torch.sum((sp * gp) * step_p))
    d2_dot = torch.sum(D2c * step_c * step_c) + psum_p(torch.sum(D2p * step_p * step_p))
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
        FtF = (env.onehot.T @ _outer_flat(Js_c, Js_c, _R, _TC, _TC)).reshape(C, _TC, _TC)
    FtF = env.psum_c(FtF)
    S = _camera_system(FtF, env.psum_p(A.T @ A), D2c)
    u = _apply3(K64, etb.double()).to(dt)  # L^{-1} etb
    rhs = (sc * gc).reshape(-1) - env.psum_p(A.T @ u.reshape(-1))
    z = _reduced_solve(S, rhs, dt)

    # back substitution: y_p = L^{-T} (u_p - A_p z)
    Az = (A @ z).reshape(P, _TP)
    y_p = _solve_lower3_t(L3, (u - Az).double()).to(dt)
    step_c = -z.reshape(C, _TC)
    step_p = -y_p
    mcc = _model_cost_change(sc, gc, sp, gp, D2c, D2p, step_c, step_p, env.psum_p)
    return step_c, step_p, sc, sp, mcc


def lm_step_schur(cams, pts, cam_idx, pt_idx, obs, radius, w=None,
                  plan: Optional[PointPlan] = None, mesh=None):
    """One LM iteration with the exact dense-Schur step (sharded_ba.py:608):
    eliminate the points (E'E + D^2 is 3x3 block diagonal), assemble the
    reduced camera system S explicitly, Cholesky-solve it. `plan` (from
    build_point_plan over point-sorted rows) runs the point sums, gathers
    and the A spread as kernels 6, 7 and 8J. Returns a BAState. With
    `mesh`: the rows are this rank's shard, the state replicated (the JAX
    GSPMD step), every sum closed by a psum."""
    C, P = cams.shape[0], pts.shape[0]
    env = _env(cams, cam_idx, pt_idx, P, w, plan, mesh)
    r, J = _evaluate_flat(cams, pts, env.ci, obs, w, env.expand_p)
    cost = env.psum_c(0.5 * torch.sum(r * r))
    step_c, step_p, sc, sp, mcc = _schur_core(J, r, radius, env, C, P, w)
    new_cams = cams + step_c * sc
    new_pts = pts + step_p * sp
    r_new = _residual_rows(_gather_cams(new_cams, env.ci), env.expand_p(new_pts), obs)
    if w is not None:
        r_new = r_new * w[:, None]
    new_cost = env.psum_c(0.5 * torch.sum(r_new * r_new))
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
    return SchurCarry(cams, pts, radius, env.psum_c(0.5 * torch.sum(r * r)), r, J)


def _next(carry: SchurCarry, obs, w, env: _Env) -> SchurCarry:
    cams, pts, radius, cost, r, J = carry
    C, P = cams.shape[0], pts.shape[0]
    step_c, step_p, sc, sp, mcc = _schur_core(J, r, radius, env, C, P, w)
    new_cams = cams + step_c * sc
    new_pts = pts + step_p * sp
    r_new, J_new = _evaluate_flat(new_cams, new_pts, env.ci, obs, w, env.expand_p)
    new_cost = env.psum_c(0.5 * torch.sum(r_new * r_new))
    accept, radius_out = _accept(cost, new_cost, mcc, radius, finite_check=True)
    return SchurCarry(torch.where(accept, new_cams, cams),
                      torch.where(accept, new_pts, pts), radius_out,
                      torch.where(accept, new_cost, cost),
                      torch.where(accept, r_new, r), torch.where(accept, J_new, J))


def lm_step_schur_init(cams, pts, cam_idx, pt_idx, obs, radius, w=None,
                       plan: Optional[PointPlan] = None, mesh=None) -> SchurCarry:
    """`mesh`: the points and their rows sharded over it, as the JAX
    `axis_name` (sharded_ba.py:679): the cost closes with a psum."""
    return _init(cams, pts, obs, radius, w,
                 _env(cams, cam_idx, pt_idx, pts.shape[0], w, plan, mesh, True))


def lm_step_schur_next(carry: SchurCarry, cam_idx, pt_idx, obs, w=None,
                       plan: Optional[PointPlan] = None, mesh=None) -> SchurCarry:
    """lm_step_schur with the evaluation carried across iterations; with
    `mesh`, over a rank's own points, the camera side of the step closed
    by a psum each (sharded_ba.py:460-477)."""
    return _next(carry, obs, w, _env(carry.cams, cam_idx, pt_idx, carry.pts.shape[0], w,
                                     plan, mesh, True))


def lm_step_schur_k(cams, pts, cam_idx, pt_idx, obs, radius, k=5, w=None,
                    plan: Optional[PointPlan] = None, mesh=None) -> BAState:
    """k LM iterations with the evaluation carry (sharded_ba.py:737): one
    evaluation per iteration, no host sync inside. Returns the BAState
    after k iterations. With `mesh`, pts and the rows are a rank's
    shard (the point-sharded tier)."""
    env = _env(cams, cam_idx, pt_idx, pts.shape[0], w, plan, mesh, True)
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
# solve_ba, with or without a mesh (sharded_ba.py:1037-1122)
# --------------------------------------------------------------------------


def make_sharded_lm_step(mesh, cg_iters: int = 10, step: str = "cg"):
    """The LM step over a rank's shard of the observations with the state
    replicated (sharded_ba.py:1037): step(cams, pts, cam_idx, pt_idx, obs,
    radius, w) -> BAState, the same on every rank. step="schur": the
    exact dense-Schur step, its point and camera sums closed by a psum
    each and the 9C x 9C solve replicated; "cg": lm_step."""
    if step == "schur":
        def fn(cams, pts, cam_idx, pt_idx, obs, radius, w):
            return lm_step_schur(cams, pts, cam_idx, pt_idx, obs, radius, w, mesh=mesh)
    else:
        def fn(cams, pts, cam_idx, pt_idx, obs, radius, w):
            return lm_step(cams, pts, cam_idx, pt_idx, obs, radius, w, cg_iters, mesh)
    return fn


def _pad_to_multiple(a, m, axis=0):
    """(a padded along `axis` to a multiple of m, the (n + pad,) 0/1
    weights). The padding repeats the last row (the JAX function pads with
    zeros): a weight-0 row then adds exactly 0, never NaN * 0."""
    a = np.asarray(a)
    n = a.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return a, np.ones(n)
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths, mode="edge"), np.concatenate([np.ones(n), np.zeros(pad)])


def _rank_rows(mesh, a):
    """This rank's block of rows of a padded array."""
    n = a.shape[0] // mesh.size
    return a[mesh.rank * n:(mesh.rank + 1) * n]


def solve_ba(bal_problem, num_iterations=10, mesh=None, cg_iters=10,
             dtype=torch.float64, step="auto", device=None) -> BAState:
    """Run `num_iterations` LM steps on a BALProblem; returns the final
    BAState. step: "schur" (lm_step_schur), "cg" (lm_step), "auto" (schur
    up to 128 cameras). On the card unless device="cpu". With a mesh
    (parallel/mesh.py), each rank takes its block of the observations
    padded to a multiple of the world size, the state replicated
    (make_sharded_lm_step); the mesh's device is used."""
    dev = resolve_device(device if mesh is None else mesh.device)
    state = state_from_arrays(bal_problem.cameras, bal_problem.points, 1e4, dtype, dev)
    ci, pi, ob = (bal_problem.camera_index, bal_problem.point_index,
                  bal_problem.observations)
    w = None
    if mesh is not None:
        ci, w = _pad_to_multiple(ci, mesh.size)
        pi, _ = _pad_to_multiple(pi, mesh.size)
        ob, _ = _pad_to_multiple(ob, mesh.size)
        ci, pi, ob, w = (_rank_rows(mesh, a) for a in (ci, pi, ob, w))
        w = torch.as_tensor(w, dtype=dtype, device=dev)
    cam_idx = torch.as_tensor(np.asarray(ci, np.int64), device=dev)
    pt_idx = torch.as_tensor(np.asarray(pi, np.int64), device=dev)
    obs = torch.as_tensor(np.asarray(ob), dtype=dtype, device=dev)
    use_schur = step == "schur" or (step == "auto" and bal_problem.cameras.shape[0] <= 128)
    step_fn = make_sharded_lm_step(mesh, cg_iters, "schur" if use_schur else "cg")
    for _ in range(num_iterations):
        state = step_fn(state.cams, state.pts, cam_idx, pt_idx, obs, state.radius, w)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return state


# --------------------------------------------------------------------------
# The point-sharded tier (sharded_ba.py:1125-1261): each rank owns a
# contiguous slice of points and exactly their observations (the rows
# sorted by point, so that is a contiguous split with no halo); the
# camera state is replicated, and the camera side closes with a psum each
# inside _schur_core.
# --------------------------------------------------------------------------


class PointShardPlan(NamedTuple):
    """Host-side layout of the point-sharded step (numpy)."""

    pts: np.ndarray  # (n*Pl, 3) padded point table, shard-major
    cam_idx: np.ndarray  # (n*Bl,) global camera ids
    pt_local: np.ndarray  # (n*Bl,) int32 point id within the shard
    obs: np.ndarray  # (n*Bl, 2)
    w: np.ndarray  # (n*Bl,) 1, or 0 on padding rows
    point_slot: np.ndarray  # (P,) padded slot of each original point
    Pl: int  # points per shard (padded)
    Bl: int  # observations per shard (padded)
    n: int


def _quantile_bounds(offsets, n, B, K):
    """Shard boundaries in key space at ~equal row quantiles."""
    bounds = [0]
    for i in range(1, n):
        p = int(np.searchsorted(offsets, i * B / n, side="left"))
        bounds.append(min(max(p, bounds[-1]), K))
    bounds.append(K)
    return bounds


def plan_point_sharding(camera_index, point_index, points, observations,
                        n: int) -> PointShardPlan:
    """Points cut into n contiguous slices of ~equal observation counts,
    each shard's points and rows padded to the largest so that shapes
    are static; a padding row repeats the shard's last real row with
    weight 0, a padding point the shard's first (sharded_ba.py:1153)."""
    cam_idx = np.asarray(camera_index)
    pt_idx = np.asarray(point_index)
    pts = np.asarray(points)
    obs = np.asarray(observations)
    P, B = pts.shape[0], cam_idx.shape[0]
    order = np.argsort(pt_idx, kind="stable")
    cam_idx, pt_idx, obs = cam_idx[order], pt_idx[order], obs[order]
    offsets = np.concatenate([[0], np.cumsum(np.bincount(pt_idx, minlength=P))])
    bounds = _quantile_bounds(offsets, n, B, P)
    Pl = max(max(bounds[i + 1] - bounds[i] for i in range(n)), 1)
    Bl = max(max(int(offsets[bounds[i + 1]] - offsets[bounds[i]]) for i in range(n)), 1)
    pts_pad = np.zeros((n * Pl, pts.shape[1]), pts.dtype)
    cam_pad = np.zeros(n * Bl, cam_idx.dtype)
    ptl_pad = np.zeros(n * Bl, np.int32)
    obs_pad = np.zeros((n * Bl, obs.shape[1]), obs.dtype)
    w_pad = np.zeros(n * Bl, pts.dtype)
    point_slot = np.zeros(P, np.int64)
    for i in range(n):
        p0, p1 = bounds[i], bounds[i + 1]
        r0, r1 = int(offsets[p0]), int(offsets[p1])
        np_i, nb_i = p1 - p0, r1 - r0
        pts_pad[i * Pl: i * Pl + np_i] = pts[p0:p1]
        if np_i < Pl:
            pts_pad[i * Pl + np_i: (i + 1) * Pl] = pts[p0] if np_i else 1.0
        point_slot[p0:p1] = np.arange(i * Pl, i * Pl + np_i)
        sl = slice(i * Bl, i * Bl + nb_i)
        cam_pad[sl] = cam_idx[r0:r1]
        ptl_pad[sl] = (pt_idx[r0:r1] - p0).astype(np.int32)
        obs_pad[sl] = obs[r0:r1]
        w_pad[sl] = 1.0
        if nb_i < Bl and nb_i:
            cam_pad[i * Bl + nb_i: (i + 1) * Bl] = cam_idx[r1 - 1]
            ptl_pad[i * Bl + nb_i: (i + 1) * Bl] = pt_idx[r1 - 1] - p0
            obs_pad[i * Bl + nb_i: (i + 1) * Bl] = obs[r1 - 1]
    return PointShardPlan(pts_pad, cam_pad, ptl_pad, obs_pad, w_pad, point_slot, Pl, Bl, n)


def _shard(mesh, a, dtype=None):
    """This rank's block of a shard-major numpy array, on its device."""
    return torch.as_tensor(np.ascontiguousarray(_rank_rows(mesh, np.asarray(a))),
                           dtype=dtype, device=mesh.device)


def make_point_sharded_step(mesh, k: int = 1, plan: Optional[PointPlan] = None):
    """The k-iteration point-sharded step over this rank's shard
    (sharded_ba.py:1208): step(cams, pts_l, cam_idx_l, pt_local_l, obs_l,
    w_l, radius) -> BAState, pts this rank's (Pl, 3) slice, cams, radius
    and cost replicated. `plan`: the kernel plan of the rank's rows
    (build_point_plan), its sums, gathers and A spread then kernels 6, 7
    and 8J."""
    def step(cams, pts_l, cam_idx_l, pt_local_l, obs_l, w_l, radius):
        return lm_step_schur_k(cams, pts_l, cam_idx_l, pt_local_l, obs_l, radius, k=k,
                               w=w_l, plan=plan, mesh=mesh)
    return step


def solve_ba_point_sharded(b, num_iterations=10, mesh=None, k=None, radius0=1e4):
    """The point-sharded LM on a BALProblem-like `b` (sharded_ba.py:1236):
    returns (BAState with this rank's (Pl, 3) points, the plan). The
    rank's point sums, gathers and A spread run as kernels 6, 7 and 8J
    over a plan of its own rows."""
    from .mesh import make_mesh

    mesh = mesh or make_mesh(axis="pt")
    dev = mesh.device
    plan = plan_point_sharding(b.camera_index, b.point_index, b.points, b.observations,
                               mesh.size)
    cams = torch.as_tensor(np.asarray(b.cameras), device=dev)
    dt = cams.dtype
    pts = _shard(mesh, plan.pts, dt)
    cam_idx = _shard(mesh, plan.cam_idx.astype(np.int64))
    pt_local = _shard(mesh, plan.pt_local)
    obs = _shard(mesh, plan.obs, dt)
    w = _shard(mesh, plan.w, dt)
    k = k or num_iterations
    step = make_point_sharded_step(mesh, k, build_point_plan(cam_idx, pt_local, plan.Pl,
                                                             cams.shape[0], dev))
    st = BAState(cams, pts, torch.tensor(float(radius0), dtype=dt, device=dev),
                 torch.zeros((), dtype=dt, device=dev))
    done = 0
    while done < num_iterations:
        st = step(st.cams, st.pts, cam_idx, pt_local, obs, w, st.radius)
        done += k
    return st, plan


# --------------------------------------------------------------------------
# The camera-sharded tier (sharded_ba.py:1264-1593): the camera AND point
# tables partitioned, the observations living with their camera's owner
# (every camera-side sum local); the point table gathered once an
# iteration, the point-side sums closed by a psum each. CG's point
# vectors are replicated.
# --------------------------------------------------------------------------


class CameraShardPlan(NamedTuple):
    """Host-side layout of the fully sharded (camera + point) step."""

    cams: np.ndarray  # (n*Cl, 9) padded camera table, shard-major
    pts: np.ndarray  # (n*Pl, 3) padded point table, shard-major
    cam_local: np.ndarray  # (n*Bl,) int32 camera id within the shard
    pt_slot: np.ndarray  # (n*Bl,) int32 slot in the padded point table
    obs: np.ndarray  # (n*Bl, 2)
    w: np.ndarray  # (n*Bl,) 1, or 0 on padding rows
    camera_slot: np.ndarray  # (C,) padded slot of each original camera
    point_slot: np.ndarray  # (P,) padded slot of each original point
    Cl: int
    Pl: int
    Bl: int
    n: int


def plan_camera_sharding(camera_index, point_index, cameras, points, observations,
                         n: int) -> CameraShardPlan:
    """Cameras cut into n contiguous slices of ~equal observation counts
    (the observations follow their camera), points into n equal slices;
    both tables and each shard's rows padded to static shapes, a padding
    row repeating the shard's last real row with weight 0
    (sharded_ba.py:1298)."""
    cam_idx = np.asarray(camera_index)
    pt_idx = np.asarray(point_index)
    cams = np.asarray(cameras)
    pts = np.asarray(points)
    obs = np.asarray(observations)
    C, P, B = cams.shape[0], pts.shape[0], cam_idx.shape[0]
    Pl = -(-P // n)
    pts_pad = np.zeros((n * Pl, pts.shape[1]), pts.dtype)
    point_slot = np.zeros(P, np.int64)
    for i in range(n):
        p0, p1 = i * Pl, min((i + 1) * Pl, P)
        np_i = max(p1 - p0, 0)
        if np_i > 0:
            pts_pad[i * Pl: i * Pl + np_i] = pts[p0:p1]
            point_slot[p0:p1] = np.arange(i * Pl, i * Pl + np_i)
        if np_i < Pl:
            pts_pad[i * Pl + np_i: (i + 1) * Pl] = pts[p0] if np_i else 1.0
    order = np.argsort(cam_idx, kind="stable")
    cam_s, pt_s, obs_s = cam_idx[order], pt_idx[order], obs[order]
    offsets = np.concatenate([[0], np.cumsum(np.bincount(cam_s, minlength=C))])
    bounds = _quantile_bounds(offsets, n, B, C)
    Cl = max(max(bounds[i + 1] - bounds[i] for i in range(n)), 1)
    Bl = max(max(int(offsets[bounds[i + 1]] - offsets[bounds[i]]) for i in range(n)), 1)
    cams_pad = np.zeros((n * Cl, cams.shape[1]), cams.dtype)
    caml_pad = np.zeros(n * Bl, np.int32)
    pslot_pad = np.zeros(n * Bl, np.int32)
    obs_pad = np.zeros((n * Bl, obs.shape[1]), obs.dtype)
    w_pad = np.zeros(n * Bl, pts.dtype)
    camera_slot = np.zeros(C, np.int64)
    for i in range(n):
        c0, c1 = bounds[i], bounds[i + 1]
        r0, r1 = int(offsets[c0]), int(offsets[c1])
        nc_i, nb_i = c1 - c0, r1 - r0
        if nc_i > 0:
            cams_pad[i * Cl: i * Cl + nc_i] = cams[c0:c1]
            camera_slot[c0:c1] = np.arange(i * Cl, i * Cl + nc_i)
        if nc_i < Cl:
            cams_pad[i * Cl + nc_i: (i + 1) * Cl] = cams[c0] if nc_i else 1.0
        sl = slice(i * Bl, i * Bl + nb_i)
        caml_pad[sl] = (cam_s[r0:r1] - c0).astype(np.int32)
        pslot_pad[sl] = point_slot[pt_s[r0:r1]].astype(np.int32)
        obs_pad[sl] = obs_s[r0:r1]
        w_pad[sl] = 1.0
        if nb_i < Bl and nb_i:
            caml_pad[i * Bl + nb_i: (i + 1) * Bl] = cam_s[r1 - 1] - c0
            pslot_pad[i * Bl + nb_i: (i + 1) * Bl] = point_slot[pt_s[r1 - 1]]
            obs_pad[i * Bl + nb_i: (i + 1) * Bl] = obs_s[r1 - 1]
    return CameraShardPlan(cams_pad, pts_pad, caml_pad, pslot_pad, obs_pad, w_pad,
                           camera_slot, point_slot, Cl, Pl, Bl, n)


def lm_step_camera_sharded(cams_l, pts_l, cam_local, pt_slot, obs, radius, mesh,
                           w=None, cg_iters: int = 10):
    """One LM iteration with this rank's cameras and its slice of the
    points (sharded_ba.py:1368): the point table gathered once, lm_step's
    CG with the camera sums local and the point sums closed by a psum
    each, the camera part of each CG inner product psummed. Returns (new
    cams_l, new pts_l, radius, cost), both tables still sharded."""
    Pl = pts_l.shape[0]
    pts = mesh.all_gather_tiled(pts_l)
    cl, ps = cam_local.long(), pt_slot.long()
    r, Jc, Jp = _evaluate(cams_l, pts, cl, ps, obs, w)
    cost = mesh.psum(0.5 * torch.sum(r * r))
    reduce_c, reduce_p = _make_reducers(cl, ps, cams_l.shape[0], pts.shape[0],
                                        psum_p=mesh.psum)
    lin = _linearize(r, Jc, Jp, cost, cl, reduce_c, reduce_p, lambda sp: sp[ps], radius)

    def matvec(vc, vp):
        jv = _jmul(lin, vc[cl], vp[ps])
        return (reduce_c(torch.sum(lin.Jsc * jv[:, :, None], dim=1)) + lin.D2c * vc,
                reduce_p(torch.sum(lin.Jsp * jv[:, :, None], dim=1)) + lin.D2p * vp)

    def dots(ac, bc, ap, bp):
        return mesh.psum(torch.sum(ac * bc)) + torch.sum(ap * bp)

    yc, yp = _cg_fixed(matvec, lin.rhs_c, lin.rhs_p, lin.Minv_c, lin.Minv_p, cg_iters, dots)
    step_c, step_p = -yc, -yp
    jstep = _jmul(lin, step_c[cl], step_p[ps])
    mcc = mesh.psum(-torch.sum(jstep * (r + jstep / 2.0)))
    new_cams = cams_l + step_c * lin.sc
    new_pts = pts + step_p * lin.sp
    new_cost = mesh.psum(ba_cost(new_cams, new_pts, cl, ps, obs, w))
    accept, radius_out = _accept(cost, new_cost, mcc, radius, finite_check=False)
    pts_out = torch.where(accept, new_pts, pts)
    start = mesh.axis_index() * Pl
    return (torch.where(accept, new_cams, cams_l), pts_out[start:start + Pl], radius_out,
            torch.where(accept, new_cost, cost))


def make_camera_sharded_step(mesh, k: int = 1, cg_iters: int = 10):
    """k camera-sharded iterations (sharded_ba.py:1492): step(cams_l,
    pts_l, cam_local_l, pt_slot_l, obs_l, w_l, radius) -> BAState with
    both tables still this rank's shards."""
    def step(cams_l, pts_l, cam_local, pt_slot, obs_l, w_l, radius):
        c, p, rad, co = cams_l, pts_l, radius, torch.zeros_like(radius)
        for _ in range(k):
            c, p, rad, co = lm_step_camera_sharded(c, p, cam_local, pt_slot, obs_l, rad,
                                                   mesh, w=w_l, cg_iters=cg_iters)
        return BAState(c, p, rad, co)
    return step


def solve_ba_camera_sharded(b, num_iterations=10, mesh=None, k=None, radius0=1e4,
                            cg_iters: int = 10, halo="auto"):
    """The fully sharded LM (camera and point tables partitioned) on a
    BALProblem-like `b` (sharded_ba.py:1525): returns (BAState with this
    rank's camera and point shards, the plan). `halo`: True exchanges only
    the visibility cut (plan_camera_halo); False gathers the point table
    (plan_camera_sharding); "auto" takes the halo where its rows, n * Hs
    a rank, are under half of the padded point table."""
    from .mesh import make_mesh

    mesh = mesh or make_mesh(axis="cam")
    n, dev = mesh.size, mesh.device
    hplan = None
    if halo == "auto" or halo is True:
        hplan = plan_camera_halo(b.camera_index, b.point_index, b.cameras, b.points,
                                 b.observations, n)
        if halo == "auto" and n * hplan.Hs > hplan.pts.shape[0] // 2:
            hplan = None
    plan = hplan if hplan is not None else plan_camera_sharding(
        b.camera_index, b.point_index, b.cameras, b.points, b.observations, n)
    dt = torch.as_tensor(plan.cams[:1]).dtype
    cams, pts = _shard(mesh, plan.cams, dt), _shard(mesh, plan.pts, dt)
    cam_local = _shard(mesh, plan.cam_local)
    obs, w = _shard(mesh, plan.obs, dt), _shard(mesh, plan.w, dt)
    k = k or num_iterations
    if hplan is not None:
        pt_ref = _shard(mesh, plan.pt_halo)
        srv = torch.as_tensor(plan.srv_idx[mesh.rank], device=dev)
        step = make_camera_halo_step(mesh, k, cg_iters)
        args = (cam_local, pt_ref, obs, w, srv)
    else:
        pt_slot = _shard(mesh, plan.pt_slot)
        step = make_camera_sharded_step(mesh, k, cg_iters)
        args = (cam_local, pt_slot, obs, w)
    st = BAState(cams, pts, torch.tensor(float(radius0), dtype=dt, device=dev),
                 torch.zeros((), dtype=dt, device=dev))
    done = 0
    while done < num_iterations:
        st = step(st.cams, st.pts, *args, st.radius)
        done += k
    return st, plan


# --------------------------------------------------------------------------
# The visibility-cut halo exchange (sharded_ba.py:1596-1879): each rank
# exchanges only the point rows its observations touch. Per (requester i,
# owner j) pair the sorted j-local rows i needs, padded to the largest
# count Hs; observations address points by halo-local index j*Hs + k.
# The forward exchange serves those rows with one tiled all-to-all; the
# reverse returns halo-space sums to their owners through the same lists,
# added into the owned rows in a fixed order.
# --------------------------------------------------------------------------


class CameraHaloPlan(NamedTuple):
    """Host-side layout of the halo-exchange step."""

    cams: np.ndarray  # (n*Cl, 9)
    pts: np.ndarray  # (n*Pl, 3)
    cam_local: np.ndarray  # (n*Bl,) int32 camera id within the shard
    pt_halo: np.ndarray  # (n*Bl,) int32 halo-local point index (j*Hs + k)
    obs: np.ndarray  # (n*Bl, 2)
    w: np.ndarray  # (n*Bl,)
    srv_idx: np.ndarray  # (n, n, Hs) int32: srv_idx[j, i] = j-local rows j serves i
    camera_slot: np.ndarray
    point_slot: np.ndarray
    Cl: int
    Pl: int
    Bl: int
    Hs: int  # most rows any rank asks of one owner
    n: int


def plan_camera_halo(camera_index, point_index, cameras, points, observations,
                     n: int) -> CameraHaloPlan:
    """plan_camera_sharding and each shard's halo lists (sharded_ba.py:1638)."""
    base = plan_camera_sharding(camera_index, point_index, cameras, points,
                                observations, n)
    Pl, Bl = base.Pl, base.Bl
    slot = np.asarray(base.pt_slot)
    reqs = []
    Hs = 1
    for i in range(n):
        u = np.unique(slot[i * Bl: (i + 1) * Bl])
        owner = u // Pl
        per = [np.ascontiguousarray((u[owner == j] % Pl).astype(np.int32)) for j in range(n)]
        Hs = max(Hs, max(p.shape[0] for p in per))
        reqs.append(per)
    srv = np.zeros((n, n, Hs), np.int32)
    for i in range(n):
        for j in range(n):
            srv[j, i, : reqs[i][j].shape[0]] = reqs[i][j]
    pt_halo = np.zeros(n * Bl, np.int32)
    for i in range(n):
        sl = slice(i * Bl, (i + 1) * Bl)
        s = slot[sl]
        j = s // Pl
        loc = (s % Pl).astype(np.int32)
        kk = np.empty(s.shape[0], np.int32)
        for jj in range(n):
            m = j == jj
            if m.any():
                kk[m] = np.searchsorted(reqs[i][jj], loc[m]).astype(np.int32)
        pt_halo[sl] = (j * Hs + kk).astype(np.int32)
    return CameraHaloPlan(base.cams, base.pts, base.cam_local, pt_halo, base.obs, base.w,
                          srv, base.camera_slot, base.point_slot, base.Cl, Pl, Bl, Hs, n)


def _halo_fwd(v_own, srv_l, mesh):
    """This rank's halo table (n*Hs, d) of the owned rows v_own (Pl, d):
    chunk j holds the rows it asked of rank j, in its request order;
    srv_l (n, Hs) the owned rows it serves each rank."""
    return mesh.all_to_all_tiled(v_own[srv_l.reshape(-1).long()])


def _halo_rev(contrib_halo, srv_l, mesh, Pl):
    """The adjoint of _halo_fwd: halo-space sums (n*Hs, d) back to their
    owners and added into the owned rows (Pl, d), in a fixed order."""
    back = mesh.all_to_all_tiled(contrib_halo)
    return _sum_by(srv_l.reshape(-1).long(), Pl, back)


def _halo_linearize(cams_l, pts_own, cam_local, pt_halo, obs, srv_l, radius, mesh,
                    w=None, min_diag=1e-6, max_diag=1e32, evaluate=None):
    """The halo tiers' linearization (sharded_ba.py:1693): evaluate over
    the halo table, the camera sums local, the point sums closed in halo
    space through one reverse exchange. Returns (_Linearization, matvec,
    reduce_p)."""
    Pl, n, Hs = pts_own.shape[0], srv_l.shape[0], srv_l.shape[1]
    halo_pts = _halo_fwd(pts_own, srv_l, mesh)
    cl, ph = cam_local.long(), pt_halo.long()
    r, Jc, Jp = (evaluate or _evaluate)(cams_l, halo_pts, cl, ph, obs, w)
    cost = mesh.psum(0.5 * torch.sum(r * r))
    reduce_c, reduce_h = _make_reducers(cl, ph, cams_l.shape[0], n * Hs)

    def reduce_p(contrib):
        return _halo_rev(reduce_h(contrib), srv_l, mesh, Pl)

    lin = _linearize(r, Jc, Jp, cost, cl, reduce_c, reduce_p,
                     lambda sp: _halo_fwd(sp, srv_l, mesh)[ph], radius, min_diag, max_diag)

    def matvec(vc, vp):
        jv = _jmul(lin, vc[cl], _halo_fwd(vp, srv_l, mesh)[ph])
        return (reduce_c(torch.sum(lin.Jsc * jv[:, :, None], dim=1)) + lin.D2c * vc,
                reduce_p(torch.sum(lin.Jsp * jv[:, :, None], dim=1)) + lin.D2p * vp)

    return lin, matvec


def _halo_candidate(lin, step_c, step_p, new_pts, cam_local, pt_halo, srv_l, mesh):
    """(the model cost change, the candidate's halo points): ONE forward
    exchange for the point step and the candidate points."""
    tp = step_p.shape[1]
    both = _halo_fwd(torch.cat([step_p, new_pts], dim=1), srv_l, mesh)
    ph = pt_halo.long()
    jstep = _jmul(lin, step_c[cam_local.long()], both[:, :tp][ph])
    mcc = mesh.psum(-torch.sum(jstep * (lin.r + jstep / 2.0)))
    return mcc, both[:, tp:]


def lm_step_camera_halo(cams_l, pts_own, cam_local, pt_halo, obs, srv_l, radius, mesh,
                        w=None, cg_iters: int = 10):
    """One LM iteration on the halo layout (sharded_ba.py:1766): the
    camera sums local, the point sums closed in halo space, CG's state in
    owned point space (each matvec one forward and one reverse exchange).
    Returns (new cams_l, new pts_own, radius, cost)."""
    lin, matvec = _halo_linearize(cams_l, pts_own, cam_local, pt_halo, obs, srv_l,
                                  radius, mesh, w)

    def dots(ac, bc, ap, bp):
        return mesh.psum(torch.sum(ac * bc) + torch.sum(ap * bp))

    yc, yp = _cg_fixed(matvec, lin.rhs_c, lin.rhs_p, lin.Minv_c, lin.Minv_p, cg_iters, dots)
    step_c, step_p = -yc, -yp
    new_cams = cams_l + step_c * lin.sc
    new_pts = pts_own + step_p * lin.sp
    mcc, cand_h = _halo_candidate(lin, step_c, step_p, new_pts, cam_local, pt_halo,
                                  srv_l, mesh)
    new_cost = mesh.psum(ba_cost(new_cams, cand_h, cam_local.long(), pt_halo.long(), obs,
                                 w))
    accept, radius_out = _accept(lin.cost, new_cost, mcc, radius, finite_check=False)
    return (torch.where(accept, new_cams, cams_l), torch.where(accept, new_pts, pts_own),
            radius_out, torch.where(accept, new_cost, lin.cost))


def make_camera_halo_step(mesh, k: int = 1, cg_iters: int = 10):
    """k halo iterations (sharded_ba.py:1847): step(cams_l, pts_l,
    cam_local_l, pt_halo_l, obs_l, w_l, srv_l, radius) -> BAState, both
    tables still this rank's shards; srv_l is srv_idx[rank]."""
    def step(cams_l, pts_l, cam_local, pt_halo, obs_l, w_l, srv_l, radius):
        c, p, rad, co = cams_l, pts_l, radius, torch.zeros_like(radius)
        for _ in range(k):
            c, p, rad, co = lm_step_camera_halo(c, p, cam_local, pt_halo, obs_l, srv_l,
                                                rad, mesh, w=w_l, cg_iters=cg_iters)
        return BAState(c, p, rad, co)
    return step


# --------------------------------------------------------------------------
# The Ceres-semantics halo tier (sharded_ba.py:1882-2216): the host
# loop's options subset, step evaluator and termination taxonomy on the
# halo layout, its CG the generic conjugate_gradients with psum-closed
# inner products and norms. The JAX body keeps every decision a
# replicated device scalar inside a while_loop; here the decision's
# scalars come out of collectives and are fetched once an iteration (and
# once a CG iteration), and every rank decides alike on the host.
# --------------------------------------------------------------------------

# termination codes (solvers.fused_lm's)
HALO_RUNNING = 0
HALO_GRADIENT_TOL = 1
HALO_MIN_RADIUS = 2
HALO_PARAM_TOL = 3
HALO_FUNC_TOL = 4
HALO_INVALID_STEPS = 5


class ShardedLMOptions(NamedTuple):
    """The Solver::Options subset the Ceres-semantics halo step honours,
    with Ceres's defaults (sharded_ba.py:1901)."""

    min_relative_decrease: float = 1e-3
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    min_trust_region_radius: float = 1e-32
    max_trust_region_radius: float = 1e16
    eta: float = 1e-1
    max_linear_solver_iterations: int = 500
    max_num_consecutive_invalid_steps: int = 5
    use_nonmonotonic_steps: bool = False
    max_consecutive_nonmonotonic_steps: int = 5

    @classmethod
    def from_options(cls, o):
        """The fields of an Options."""
        return cls(**{f: getattr(o, f) for f in cls._fields})


class HaloCarry(NamedTuple):
    """The halo tier's state between iterations: this rank's tables, and
    the replicated host scalars."""

    cams: torch.Tensor
    pts: torch.Tensor
    radius: float
    cost: torch.Tensor  # 0-d float64
    se: object  # solvers.trust_region.TrustRegionStepEvaluator, None before the first
    decrease_factor: float
    num_invalid: int
    any_success: bool
    term: int  # HALO_*
    it: int


def _count_fetch(*scalars):
    return torch.stack([s.to(torch.float64).reshape(()) for s in scalars]).tolist()


def lm_step_camera_halo_ceres(carry: HaloCarry, cam_local, pt_halo, obs, srv_l, mesh, w,
                              opts: ShardedLMOptions, evaluate=None, cost_fn=None,
                              plus_c=None, plus_e=None) -> HaloCarry:
    """One Ceres-semantics LM iteration on the halo layout
    (sharded_ba.py:1954): levenberg_marquardt_strategy.cc's damping and
    radius rules (the doubling decrease factor), the step evaluator's
    (non)monotonic acceptance, the tolerances in trust_region_minimizer.cc's
    order, and a CG failure counted as an invalid step. `evaluate`,
    `cost_fn`, `plus_c` and `plus_e` generalize it to a program's cost and
    manifolds (parallel/sharded_program.py)."""
    from ..solvers.linear.cg import CG_FAILURE, conjugate_gradients
    from ..solvers.trust_region import TrustRegionStepEvaluator

    cams_l, pts_own, radius = carry.cams, carry.pts, carry.radius
    lin, matvec = _halo_linearize(cams_l, pts_own, cam_local, pt_halo, obs, srv_l, radius,
                                  mesh, w, opts.min_lm_diagonal, opts.max_lm_diagonal,
                                  evaluate)
    # tangent widths from the linearization (the ambient ones differ
    # under a manifold)
    tc, tp = lin.rhs_c.shape[1], lin.rhs_p.shape[1]
    Cl, Pl = cams_l.shape[0], pts_own.shape[0]
    nc = Cl * tc

    def unflat(v):
        return v[:nc].reshape(Cl, tc), v[nc:].reshape(Pl, tp)

    def lhs(v):
        qc, qp = matvec(*unflat(v))
        return torch.cat([qc.reshape(-1), qp.reshape(-1)])

    minv = torch.cat([lin.Minv_c.reshape(-1), lin.Minv_p.reshape(-1)])
    rhs = torch.cat([lin.rhs_c.reshape(-1), lin.rhs_p.reshape(-1)])
    res = conjugate_gradients(
        lhs, rhs, torch.zeros_like(rhs), lambda v: minv * v,
        fetch=_count_fetch, max_num_iterations=opts.max_linear_solver_iterations, residual_reset_period=10,
        r_tolerance=-1.0, q_tolerance=opts.eta,
        dot=lambda a, b: mesh.psum(torch.dot(a, b)),
        norm=lambda a: torch.sqrt(mesh.psum(torch.sum(a * a))))
    yc, yp = unflat(res.x)
    step_c, step_p = -yc, -yp
    new_cams = cams_l + step_c * lin.sc if plus_c is None else plus_c(cams_l, step_c * lin.sc)
    new_pts = pts_own + step_p * lin.sp if plus_e is None else plus_e(pts_own, step_p * lin.sp)
    mcc_t, cand_h = _halo_candidate(lin, step_c, step_p, new_pts, cam_local, pt_halo,
                                    srv_l, mesh)
    new_cost_t = mesh.psum((cost_fn or ba_cost)(new_cams, cand_h, cam_local.long(),
                                                pt_halo.long(), obs, w))
    # the step's finiteness closed over the mesh, so `valid` is replicated
    bad_x = mesh.psum(torch.sum((~torch.isfinite(res.x)).to(lin.cost.dtype)))
    x_norm = torch.sqrt(mesh.psum(torch.sum(cams_l * cams_l) + torch.sum(pts_own * pts_own)))
    step_norm = torch.sqrt(mesh.psum(torch.sum((step_c * lin.sc) ** 2)
                                     + torch.sum((step_p * lin.sp) ** 2)))
    gmax = mesh.pmax(torch.maximum(torch.max(torch.abs(lin.gc)),
                                   torch.max(torch.abs(lin.gp))))
    cost, mcc, new_cost, bad, xn, sn, gm = _count_fetch(lin.cost, mcc_t, new_cost_t, bad_x,
                                                        x_norm, step_norm, gmax)
    max_steps = (opts.max_consecutive_nonmonotonic_steps if opts.use_nonmonotonic_steps
                 else 0)
    se = carry.se if carry.se is not None else TrustRegionStepEvaluator(cost, max_steps)

    valid = (res.termination != CG_FAILURE and mcc > 0.0 and np.isfinite(new_cost)
             and bad == 0.0)
    num_invalid = 0 if valid else carry.num_invalid + 1
    term = (HALO_INVALID_STEPS if not valid
            and num_invalid >= opts.max_num_consecutive_invalid_steps else HALO_RUNNING)
    # tolerances (trust_region_minimizer.cc order); the gradient test at
    # the current iterate, whose gradient this linearization holds
    ptol = opts.parameter_tolerance
    grad_hit = gm <= opts.gradient_tolerance
    param_hit = valid and carry.any_success and sn <= ptol * (xn + ptol) and not grad_hit
    func_hit = (valid and not param_hit and not grad_hit
                and abs(cost - new_cost) <= opts.function_tolerance * cost)
    if grad_hit:
        term = HALO_GRADIENT_TOL
    if param_hit:
        term = HALO_PARAM_TOL
    elif func_hit:
        term = HALO_FUNC_TOL
    breaking = term != HALO_RUNNING

    mcc_c = max(mcc, 1e-300)
    rel_dec = se.step_quality(new_cost, mcc_c)
    success = valid and not breaking and rel_dec > opts.min_relative_decrease
    if success:
        se.step_accepted(new_cost, mcc_c)
        cams_l, pts_own, cost_t = new_cams, new_pts, new_cost_t
        radius_new = min(radius / max(1.0 / 3.0, 1.0 - (2.0 * rel_dec - 1.0) ** 3),
                         opts.max_trust_region_radius)
        decrease = 2.0
    else:
        cost_t = lin.cost
        radius_new = radius if breaking else radius / carry.decrease_factor
        decrease = carry.decrease_factor if breaking else carry.decrease_factor * 2.0
    if term == HALO_RUNNING and radius_new <= opts.min_trust_region_radius:
        term = HALO_MIN_RADIUS
    return HaloCarry(cams_l, pts_own, radius_new, cost_t.to(torch.float64), se, decrease,
                     num_invalid, carry.any_success or success, term, carry.it + 1)


def make_camera_halo_ceres_step(mesh, opts: ShardedLMOptions, k: int = 1, evaluate=None,
                                cost_fn=None, plus_c=None, plus_e=None):
    """Up to k Ceres-semantics halo iterations, stopping early once a
    termination fires (sharded_ba.py:2116): step(carry, cam_local_l,
    pt_halo_l, obs_l, w_l, srv_l) -> HaloCarry."""
    def step(carry, cam_local, pt_halo, obs_l, w_l, srv_l):
        k_end = carry.it + k
        while carry.term == HALO_RUNNING and carry.it < k_end:
            carry = lm_step_camera_halo_ceres(carry, cam_local, pt_halo, obs_l, srv_l, mesh,
                                              w_l, opts, evaluate, cost_fn, plus_c, plus_e)
        return carry
    return step


def _halo_terminal(code):
    from ..types import TerminationType

    if code in (HALO_GRADIENT_TOL, HALO_MIN_RADIUS, HALO_PARAM_TOL, HALO_FUNC_TOL):
        return TerminationType.CONVERGENCE
    if code == HALO_INVALID_STEPS:
        return TerminationType.FAILURE
    return TerminationType.NO_CONVERGENCE


def _sharded_lm_options(options, max_num_iterations):
    """(ShardedLMOptions, the iteration cap): an explicit cap wins over
    options.max_num_iterations, 50 when neither is given."""
    if options is None:
        opts = ShardedLMOptions()
    elif isinstance(options, ShardedLMOptions):
        opts = options
    else:
        opts = ShardedLMOptions.from_options(options)
        if max_num_iterations is None:
            max_num_iterations = options.max_num_iterations
    return opts, 50 if max_num_iterations is None else max_num_iterations


def run_halo_ceres(mesh, plan: CameraHaloPlan, cams, pts, opts, max_num_iterations, k,
                   radius0, dtype, **fns) -> HaloCarry:
    """The halo-Ceres loop over this rank's shards of `plan` from the
    padded tables cams and pts (numpy)."""
    cam_local = _shard(mesh, plan.cam_local)
    pt_ref = _shard(mesh, plan.pt_halo)
    srv = torch.as_tensor(plan.srv_idx[mesh.rank], device=mesh.device)
    obs, w = _shard(mesh, plan.obs, dtype), _shard(mesh, plan.w, dtype)
    step = make_camera_halo_ceres_step(mesh, opts, k, **fns)
    carry = HaloCarry(_shard(mesh, cams, dtype), _shard(mesh, pts, dtype), float(radius0),
                      torch.zeros((), dtype=torch.float64, device=mesh.device), None, 2.0,
                      0, False, HALO_RUNNING, 0)
    while carry.it < max_num_iterations and carry.term == HALO_RUNNING:
        carry = step(carry, cam_local, pt_ref, obs, w, srv)
    return carry


def solve_ba_camera_halo_ceres(b, options=None, mesh=None, k=4, radius0=1e4,
                               max_num_iterations=None, info: Optional[dict] = None):
    """The halo-sharded LM under the Ceres options (sharded_ba.py:2163).
    `options`: an Options, a ShardedLMOptions or None (Ceres's defaults).
    Returns (BAState with this rank's shards, the plan, TerminationType);
    `info`, a dict when given, receives "iterations", the LM iterations
    run."""
    from .mesh import make_mesh

    opts, max_iters = _sharded_lm_options(options, max_num_iterations)
    mesh = mesh or make_mesh(axis="cam")
    plan = plan_camera_halo(b.camera_index, b.point_index, b.cameras, b.points,
                            b.observations, mesh.size)
    dt = torch.as_tensor(plan.cams[:1]).dtype
    c = run_halo_ceres(mesh, plan, plan.cams, plan.pts, opts, max_iters, k, radius0, dt)
    if info is not None:
        info["iterations"] = c.it
    state = BAState(c.cams, c.pts, torch.tensor(c.radius, dtype=dt, device=mesh.device),
                    c.cost)
    return state, plan, _halo_terminal(c.term)
