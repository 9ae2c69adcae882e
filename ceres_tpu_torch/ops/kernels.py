"""The kernels of the ported Schur paths (counterpart of
ceres_tpu/ops/pallas_kernels.py).

Each wrapper takes tensors on one device. On the CPU it runs the kernel's
plain PyTorch version; on a CUDA device it launches the hand-written CUDA
kernel (csrc/*.cu, built by ops/build.py) on the current stream, or raises:
there is no fallback from one to the other. Each wrapper carries two plain
integers: `launches`, counted where the CUDA kernel is launched, and
`plain_calls`, counted where the plain version runs.

The jt-mode kernels (1-5) take the shapes of the Snavely BA path: r = 2
residual rows, tf = 9 camera and te = 3 point tangent columns. eval_fused
(1) computes the angle-axis camera model or the quaternion one (10 ambient
parameters, its lanes in the 9 tangent coordinates), with a robust loss
applied by the Triggs corrector; its two further variants count on their
own wrappers, eval_fused_loss (1L) and eval_fused_quat (1Q). J travels
transposed, as JT (24, B) (layout in csrc/common.cuh), residuals as rT
(2, B). Their `plan` argument is a flatops.RowPlan: rows sorted by point,
the point segments and blocks, the camera plans (each row's place in
camera order, the runs of one camera within a tile of rows, their trees of
levels) and, for schur_assembly, the point-pair plan. A row whose camera
id is C or more belongs to a constant camera (the sentinel): eval_fused
reads its camera from the camera table, every point-side sum takes the
row, with no camera step (x_c, z and the camera scales are zero there),
and no camera-side sum does; the plain versions follow the same rule.

The flat-path kernels (6-9) take any width: segment sums of (B, w) rows
by block id through a flatops.SegmentPlan (6 sorted, 9 unsorted), the
gather of block rows back to the rows (7), and the spread sum that
assembles the dense-Schur A (8), with the camera Gram blocks F'F when
given the camera Jacobian rows (8J, parallel/sharded_ba.py's pipeline).

Every size and offset a kernel computes from B, P or C is 64-bit where
it can pass 2^31 (24 * B passes it at B = 90M rows).
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

R, TF, TE = 2, 9, 3
LANES = R * (TF + TE)
E_OFF = R * TF
CHUNK = 64  # rows (runs, pairs) per chunk; CT_CHUNK in csrc/common.cuh
POINT_BLOCK = 256  # rows and points of a point block; kBlock in csrc/point_blocks.cuh
SEG_TILE = 128  # rows of a tile of segment_block_sum; kTile in csrc/segment_sum.cu
SEG_HALO = 64  # rows a run may reach past its tile: kHalo
STAGED_TILES = 4  # tiles a block of its staged pass takes: kStagedTiles
STAGE_ROW_BYTES = 64  # the widest row its staged pass takes: kStageWidth
_PT_OUT = 2 * TE + TE * TE
_CAM_OUT = 2 * TF
_UPPER = TF * (TF + 1) // 2  # entries of a 9 x 9 block's upper triangle
_Y_ROW = 24  # a row of Y's factors, Jsf and Z: kYS in csrc/schur_assembly.cu
_SA_CAM = 2 * _UPPER + TF  # a run's FtF, U and Y'Y values in schur_assembly
# the row stride of a padded camera table or workspace: w values padded to
# whole 16-byte groups (kPad in csrc/point_blocks.cuh)
_PAD = {dt: {w: -(-w * n // 16) * 16 // n for w in (TF, _CAM_OUT)}
        for dt, n in ((torch.float32, 4), (torch.float64, 8))}

_SUFFIX = {torch.float64: "f64", torch.float32: "f32"}


# --------------------------------------------------------------------------
# dispatch helpers
# --------------------------------------------------------------------------


def _on_cpu(ref: torch.Tensor) -> bool:
    """True for the plain version, False for the kernel; raises for a
    device the port has no kernel for."""
    if ref.device.type == "cpu":
        return True
    if ref.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {ref.device}")


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_plan(plan, device) -> None:
    """Each row's camera and point and each point's first row. The values
    were checked when flatops.build_row_plan built the plan (a point in
    [0, P), a camera in [0, n_cams)); here, that the camera table is at
    least as long as the cameras the kernels read by id."""
    i32 = torch.int32
    B, P = plan.B, plan.P
    if not 0 <= plan.C <= plan.n_cams:
        raise ValueError(f"a row plan of {plan.C} cameras over a camera table of "
                         f"{plan.n_cams} rows")
    _check(plan.cam_idx, "plan.cam_idx", i32, (B,), device)
    _check(plan.pt_idx, "plan.pt_idx", i32, (B,), device)
    _check(plan.pt_start, "plan.pt_start", i32, (P + 1,), device)


def _check_point_blocks(plan, device) -> None:
    """The point blocks of the row-parallel kernels (csrc/point_blocks.cuh)."""
    _check(plan.pt_block, "plan.pt_block", torch.int32, (plan.n_pt_blocks + 1,), device)


def _check_cam_levels(plan, device) -> None:
    """Each row's place in camera order and the last camera level's chunks
    of each camera; the levels themselves are checked by the RowPlan."""
    _check(plan.cam_pos, "plan.cam_pos", torch.int32, (plan.B,), device)
    _check(plan.cam_level_first, "plan.cam_level_first", torch.int32,
           (plan.C + 1,), device)


def _check_runs(plan, device) -> None:
    """The runs of one camera within a tile of rows and the last run
    level's chunks of each camera; the levels themselves are checked by the
    RowPlan."""
    i32 = torch.int32
    _check(plan.tile_first, "plan.tile_first", i32, (plan.n_pt_blocks + 1,), device)
    _check(plan.tile_run, "plan.tile_run", i32, (plan.n_tiles + 1,), device)
    _check(plan.run_start, "plan.run_start", i32, (plan.n_runs + 1,), device)
    _check(plan.run_slot, "plan.run_slot", i32, (plan.B,), device)
    _check(plan.run_pos, "plan.run_pos", i32, (plan.n_runs,), device)
    _check(plan.run_level_first, "plan.run_level_first", i32, (plan.C + 1,), device)


def _runs_args(plan):
    """The run plan as the kernels by runs take it, after pt_start and
    pt_block: n_pt_blocks, the runs, and the run levels."""
    return (plan.n_pt_blocks, _ptr(plan.tile_first), _ptr(plan.tile_run),
            _ptr(plan.run_start), _ptr(plan.run_slot), _ptr(plan.run_pos),
            len(plan.run_level_sizes), ctypes.cast(plan.run_level_ptrs, ctypes.c_void_p),
            ctypes.cast(plan.run_level_counts, ctypes.c_void_p),
            _ptr(plan.run_level_first))


def _dtype_of(ref: torch.Tensor):
    if ref.dtype not in _SUFFIX:
        raise TypeError(f"kernels take float32 or float64, not {ref.dtype}")
    return ref.dtype


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _entry(name: str, dtype):
    """The C entry point of a kernel for a dtype; builds the library on
    first use, so a missing toolkit fails before anything is allocated."""
    from .build import load

    return getattr(load(), f"{name}_{_SUFFIX[dtype]}")


def _launch(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: CUDA error {rc}")


def _split_jt(JT: torch.Tensor):
    """JT (24, B) -> J_f (B, 2, 9), J_e (B, 2, 3)."""
    B = JT.shape[1]
    Jf = JT[:E_OFF].reshape(R, TF, B).permute(2, 0, 1)
    Je = JT[E_OFF:].reshape(R, TE, B).permute(2, 0, 1)
    return Jf, Je


def _camera_sum(plan, contrib: torch.Tensor) -> torch.Tensor:
    """The sum by camera of per-row values, the sentinel's rows left out."""
    out = contrib.new_zeros((plan.C + 1,) + tuple(contrib.shape[1:]))
    return out.index_add_(0, _sentinel_cams(plan.cam_idx, plan.C), contrib)[:plan.C]


def _camera_rows(plan, table: torch.Tensor) -> torch.Tensor:
    """Each row's row of a per-camera table (C, w), zero for the sentinel."""
    padded = torch.cat([table, table.new_zeros((1,) + tuple(table.shape[1:]))])
    return padded[_sentinel_cams(plan.cam_idx, plan.C)]


def _point_sum(plan, contrib: torch.Tensor) -> torch.Tensor:
    out = contrib.new_zeros((plan.P,) + tuple(contrib.shape[1:]))
    return out.index_add_(0, plan.pt_idx.long(), contrib)


# --------------------------------------------------------------------------
# 1. eval_fused (pallas_kernels.py:2066), with its loss (1L) and
#    quaternion-camera (1Q) variants
# --------------------------------------------------------------------------

# the residual models of the kernel (csrc/eval_fused.cu): code, camera width
MODEL_SNAVELY, MODEL_SNAVELY_QUAT = 0, 1
_CAM_SIZE = {MODEL_SNAVELY: TF, MODEL_SNAVELY_QUAT: TF + 1}


def eval_model(rows_fn):
    """The kernel's model code of a row-vectorized residual, or None for
    a residual the kernel does not compute."""
    from ..models import bal

    return {bal.snavely_residual_rows: MODEL_SNAVELY,
            bal.snavely_quat_residual_rows: MODEL_SNAVELY_QUAT}.get(rows_fn)


def _chain(loss):
    from ..loss import LossChain

    return LossChain() if loss is None else loss


def eval_fused_plain(cams, pts, obs, plan, rows_fn, loss=None):
    """Residuals, the exact tangent-space Jacobian (forward-mode autodiff
    of `rows_fn`, the camera columns times the quaternion camera's
    PlusJacobian) and the f64 cost partials' sum, corrected for `loss` (a
    loss.LossChain) as the kernel does it: rho' clamped at 1e-30."""
    from .. import loss as ls
    from ..models import bal

    chain = _chain(loss)
    c = cams[plan.cam_idx.long()]
    p = pts[plan.pt_idx.long()]

    def one(ci, pi, oi):
        return rows_fn(ci, pi, oi)

    jac = torch.func.vmap(torch.func.jacfwd(one, argnums=(0, 1)))
    Jc, Jp = jac(c, p, obs)  # (B, 2, cam width), (B, 2, 3)
    res = torch.func.vmap(one)(c, p, obs)  # (B, 2)
    if eval_model(rows_fn) == MODEL_SNAVELY_QUAT:
        pj = torch.func.vmap(bal.quaternion_camera_manifold().plus_jacobian)(cams)
        Jc = torch.einsum("bra,bat->brt", Jc, pj[plan.cam_idx.long()])
    s = torch.sum(res * res, dim=1)
    if chain.ops:
        rho0, rho1, rho2 = ls.evaluate_chain(chain, s)
        rho1 = torch.clamp(rho1, min=1e-30)
        rs, asq, sqrt_r1 = ls.corrector_coefficients(s, rho1, rho2)

        def correct(J):
            rtj = torch.einsum("br,brp->bp", res, J)
            return (J - (asq[:, None] * res)[:, :, None] * rtj[:, None, :]) * \
                sqrt_r1[:, None, None]

        Jc, Jp = correct(Jc), correct(Jp)
        res = rs[:, None] * res
        s = rho0
    B = obs.shape[0]
    JT = torch.cat([Jc.permute(1, 2, 0).reshape(E_OFF, B),
                    Jp.permute(1, 2, 0).reshape(R * TE, B)], dim=0)
    cost = torch.sum(s.to(torch.float64)).reshape(1)
    return cost, res.T.contiguous(), JT.contiguous()


eval_fused_loss_plain = eval_fused_quat_plain = eval_fused_plain


def eval_fused(cams, pts, obs, plan, rows_fn, loss=None):
    """(cost (1,) f64, rT (2, B), JT (24, B)) of a Snavely residual at
    cameras (n_cams, 9) (snavely_residual_rows) or (n_cams, 10)
    (snavely_quat_residual_rows, tangent lanes), points (P, 3),
    observations (B, 2), with `loss` a loss.LossChain (None or empty: the
    trivial loss). The cost is sum |r|^2, or sum rho(|r|^2) with a loss.
    The quaternion model counts as eval_fused_quat (row 1Q), the
    angle-axis model with a loss as eval_fused_loss (row 1L)."""
    if eval_model(rows_fn) == MODEL_SNAVELY_QUAT:
        return eval_fused_quat(cams, pts, obs, plan, rows_fn, loss)
    if loss is not None and loss.ops:
        return eval_fused_loss(cams, pts, obs, plan, rows_fn, loss)
    if _on_cpu(cams):
        eval_fused.plain_calls += 1
        return eval_fused_plain(cams, pts, obs, plan, rows_fn, loss)
    out = _eval_fused_launch(cams, pts, obs, plan, rows_fn, loss)
    eval_fused.launches += 1
    return out


def eval_fused_loss(cams, pts, obs, plan, rows_fn, loss):
    """eval_fused of the angle-axis model with a robust loss (row 1L)."""
    if _on_cpu(cams):
        eval_fused_loss.plain_calls += 1
        return eval_fused_plain(cams, pts, obs, plan, rows_fn, loss)
    out = _eval_fused_launch(cams, pts, obs, plan, rows_fn, loss)
    eval_fused_loss.launches += 1
    return out


def eval_fused_quat(cams, pts, obs, plan, rows_fn, loss=None):
    """eval_fused of the quaternion-camera model, any loss (row 1Q)."""
    if _on_cpu(cams):
        eval_fused_quat.plain_calls += 1
        return eval_fused_plain(cams, pts, obs, plan, rows_fn, loss)
    out = _eval_fused_launch(cams, pts, obs, plan, rows_fn, loss)
    eval_fused_quat.launches += 1
    return out


def _eval_fused_launch(cams, pts, obs, plan, rows_fn, loss):
    from ..loss import MAX_CHAIN
    from .build import LossDesc

    model = eval_model(rows_fn)
    if model is None:
        raise ValueError(
            "the eval_fused kernel computes snavely_residual_rows and "
            "snavely_quat_residual_rows only; since port slice 3, "
            "flatops.jt_refusal sends every other residual to the flat path")
    chain = _chain(loss)
    if len(chain.ops) > MAX_CHAIN:
        raise ValueError(f"the eval_fused kernel takes a loss chain of at most "
                         f"{MAX_CHAIN} ops, not {len(chain.ops)}")
    dev = cams.device
    dt = _dtype_of(cams)
    fn = _entry("ct_eval_fused", dt)
    B, P = plan.B, plan.P
    _check_plan(plan, dev)
    _check(cams, "cams", dt, (plan.n_cams, _CAM_SIZE[model]), dev)
    _check(pts, "pts", dt, (P, TE), dev)
    _check(obs, "obs", dt, (B, R), dev)
    desc = LossDesc(len(chain.ops))
    for k, op in enumerate(chain.ops):
        desc.code[k], desc.a[k], desc.b[k] = op.code, op.a, op.b
    rT = torch.empty((R, B), dtype=dt, device=dev)
    JT = torch.empty((LANES, B), dtype=dt, device=dev)
    partial, done = _eval_workspace(max(1, -(-B // EVAL_THREADS[dt])), dev)
    cost = torch.empty((1,), dtype=torch.float64, device=dev)
    _launch(fn, _ptr(cams), _ptr(pts), _ptr(obs), _ptr(plan.cam_idx), _ptr(plan.pt_idx),
            B, model, desc, _ptr(rT), _ptr(JT), _ptr(partial), _ptr(done), _ptr(cost),
            _stream(dev))
    return cost, rT, JT


# rows of a block of the kernel (EvalShape in csrc/eval_fused.cu): a cost
# partial each, summed in the same launch by the last block to finish, in
# the order of EVAL_SUM_THREADS threads (kSumThreads)
EVAL_THREADS = {torch.float64: 128, torch.float32: 256}
EVAL_SUM_THREADS = 256
_DONE = {}


def _eval_workspace(n_blocks: int, dev):
    """eval_fused's workspace: a float64 cost partial per block, and the
    count of finished blocks, one per device and stream, which is 0 between
    calls (the last block to finish sets it back), so that no call needs a
    reset from the host."""
    key = (str(dev), _stream(dev).value)
    if key not in _DONE:
        _DONE[key] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return torch.empty((n_blocks,), dtype=torch.float64, device=dev), _DONE[key]


def eval_fused_occupancy(dev, dt, model: int, with_loss: bool) -> dict:
    """What the card makes of an eval_fused variant: threads a block,
    registers and spilled (local) bytes a thread, resident blocks an SM, and
    the card's SMs."""
    out = (ctypes.c_int * 5)()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    _launch(_entry("ct_eval_fused_occupancy", dt), index, model, int(with_loss), out)
    return dict(zip(("threads", "registers", "local_bytes", "blocks_per_sm", "sms"), out))


# --------------------------------------------------------------------------
# 2. post_eval_fused (pallas_kernels.py:1780)
# --------------------------------------------------------------------------


def post_eval_fused_plain(JT, rT, plan):
    Jf, Je = _split_jt(JT)
    r = rT.T  # (B, 2)
    g_e = torch.einsum("bik,bi->bk", Je, r)
    sqn_e = torch.sum(Je * Je, dim=1)
    ete = torch.einsum("bik,bim->bkm", Je, Je).reshape(-1, TE * TE)
    ptab = _point_sum(plan, torch.cat([g_e, sqn_e, ete], dim=1))
    g_f = torch.einsum("bia,bi->ba", Jf, r)
    sqn_f = torch.sum(Jf * Jf, dim=1)
    cam = _camera_sum(plan, torch.cat([g_f, sqn_f], dim=1))
    return ptab, cam


def post_eval_fused(JT, rT, plan):
    """(ptab (P, 15) = [g_e | sqn_e | E'E], cam (C, 18) = [g_f | sqn_f])."""
    dev = JT.device
    if _on_cpu(JT):
        post_eval_fused.plain_calls += 1
        return post_eval_fused_plain(JT, rT, plan)
    dt = _dtype_of(JT)
    fn = _entry("ct_post_eval_fused", dt)
    B, P, C = plan.B, plan.P, plan.C
    _check(JT, "JT", dt, (LANES, B), dev)
    _check(rT, "rT", dt, (R, B), dev)
    _check_plan(plan, dev)
    _check_point_blocks(plan, dev)
    _check_runs(plan, dev)
    ptab = torch.empty((P, _PT_OUT), dtype=dt, device=dev)
    w = torch.empty((max(1, plan.n_runs), _PAD[dt][_CAM_OUT]), dtype=dt, device=dev)
    work = torch.empty((max(1, sum(plan.run_level_sizes)), _CAM_OUT), dtype=dt,
                       device=dev)
    cam = torch.empty((C, _CAM_OUT), dtype=dt, device=dev)
    _launch(fn, _ptr(JT), _ptr(rT), B, C, _ptr(plan.pt_start), _ptr(plan.pt_block),
            *_runs_args(plan), _ptr(ptab), _ptr(w), _ptr(work), _ptr(cam), _stream(dev))
    post_eval_fused.launches += 1
    return ptab, cam


# --------------------------------------------------------------------------
# 3. schur_assembly, mode="dense" (pallas_kernels.py:1281)
# --------------------------------------------------------------------------


def schur_assembly_plain(JT, sc, sp, K, u, plan):
    """Straight from the definition: the dense A (P*3, C*9) of the
    eliminated system, then A'A and A'u."""
    Jf, Je = _split_jt(JT)
    pt = plan.pt_idx.long()
    Jsf = Jf * _camera_rows(plan, sc)[:, None, :]
    Jsp = Je * sp[pt][:, None, :]
    W = torch.einsum("bik,bia->bka", Jsp, Jsf)  # (B, 3, 9)
    Y = torch.einsum("bmk,bka->bma", K.reshape(-1, TE, TE)[pt], W)
    P, C = plan.P, plan.C
    A = JT.new_zeros((P, C + 1, TE, TF))  # column C takes the sentinel
    A.index_put_((pt, _sentinel_cams(plan.cam_idx, C)), Y, accumulate=True)
    A = A[:, :C].permute(0, 2, 1, 3).reshape(P * TE, C * TF)
    ata = A.T @ A
    U = A.T @ u.reshape(-1)
    ftf = _camera_sum(plan, torch.einsum("bia,bic->bac", Jsf, Jsf).reshape(-1, TF * TF))
    return ata, ftf, U


def schur_assembly(JT, sc, sp, K, u, plan):
    """(AtA (9C, 9C), FtF (C, 81), U (9C,)) of the dense-Schur reduced
    system: sc (C, 9) camera scales, sp (P, 3) point scales, K (P, 9)
    row-major per-point L^{-1} blocks, u (P, 3)."""
    dev = JT.device
    if _on_cpu(JT):
        schur_assembly.plain_calls += 1
        return schur_assembly_plain(JT, sc, sp, K, u, plan)
    dt = _dtype_of(JT)
    fn = _entry("ct_schur_assembly", dt)
    B, P, C = plan.B, plan.P, plan.C
    _check(JT, "JT", dt, (LANES, B), dev)
    _check(sc, "sc", dt, (C, TF), dev)
    _check(sp, "sp", dt, (P, TE), dev)
    _check(K, "K", dt, (P, TE * TE), dev)
    _check(u, "u", dt, (P, TE), dev)
    _check_plan(plan, dev)
    _check_point_blocks(plan, dev)
    _check_runs(plan, dev)
    pairs = plan.ensure_pairs()
    i32 = torch.int32
    NP = pairs.pair_a.shape[0]
    n_keys = C * (C + 1) // 2
    _check(pairs.pair_a, "plan.pairs.pair_a", i32, (NP,), dev)
    _check(pairs.pair_b, "plan.pairs.pair_b", i32, (NP,), dev)
    _check(pairs.pair_level_first, "plan.pairs.pair_level_first", i32, (n_keys + 1,), dev)
    _check(pairs.key_cams, "plan.pairs.key_cams", i32, (n_keys,), dev)
    psizes = pairs.pair_level_sizes  # the levels themselves: checked by PairPlan
    t_full = C * TF
    Y = torch.empty((max(1, B), _Y_ROW), dtype=dt, device=dev)
    w = torch.empty((max(1, plan.n_runs), _SA_CAM), dtype=dt, device=dev)
    run_work = torch.empty((max(1, sum(plan.run_level_sizes)), _SA_CAM), dtype=dt,
                           device=dev)
    pair_partial = torch.empty((max(1, psizes[0]), TF * TF), dtype=dt, device=dev)
    pair_work = torch.empty((max(1, sum(psizes[1:])), TF * TF), dtype=dt, device=dev)
    ata = torch.empty((t_full, t_full), dtype=dt, device=dev)
    ftf = torch.empty((C, TF * TF), dtype=dt, device=dev)
    U = torch.empty((t_full,), dtype=dt, device=dev)
    _launch(fn, _ptr(JT), B, C, _ptr(plan.cam_idx), _ptr(plan.pt_idx), _ptr(sc),
            _ptr(sp), _ptr(K), _ptr(u), _ptr(plan.pt_start), _ptr(plan.pt_block),
            *_runs_args(plan), _ptr(pairs.pair_a), _ptr(pairs.pair_b), len(psizes),
            ctypes.cast(pairs.pair_level_ptrs, ctypes.c_void_p),
            ctypes.cast(pairs.pair_level_counts, ctypes.c_void_p),
            _ptr(pairs.pair_level_first), _ptr(pairs.key_cams), _ptr(Y), _ptr(w),
            _ptr(run_work), _ptr(pair_partial), _ptr(pair_work), _ptr(ata), _ptr(ftf),
            _ptr(U), _stream(dev))
    schur_assembly.launches += 1
    return ata, ftf, U


# --------------------------------------------------------------------------
# 4. implicit_schur_matvec, mode="normal" (pallas_kernels.py:781, :1759)
# --------------------------------------------------------------------------


def normal_matvec_plain(JT, xc, xp, plan):
    Jf, Je = _split_jt(JT)
    pt = plan.pt_idx.long()
    jv = torch.einsum("bia,ba->bi", Jf, _camera_rows(plan, xc)) + torch.einsum(
        "bik,bk->bi", Je, xp[pt])
    cam_out = _camera_sum(plan, torch.einsum("bia,bi->ba", Jf, jv))
    pt_out = _point_sum(plan, torch.einsum("bik,bi->bk", Je, jv))
    return cam_out, pt_out


def normal_matvec(JT, xc, xp, plan):
    """(J'J) x for x = [xc (C, 9); xp (P, 3)] -> (cam (C, 9), pt (P, 3))."""
    dev = JT.device
    if _on_cpu(JT):
        normal_matvec.plain_calls += 1
        return normal_matvec_plain(JT, xc, xp, plan)
    dt = _dtype_of(JT)
    fn = _entry("ct_normal_matvec", dt)
    B, P, C = plan.B, plan.P, plan.C
    _check(JT, "JT", dt, (LANES, B), dev)
    _check(xc, "xc", dt, (C, TF), dev)
    _check(xp, "xp", dt, (P, TE), dev)
    _check_plan(plan, dev)
    _check_point_blocks(plan, dev)
    _check_cam_levels(plan, dev)
    sizes = plan.cam_level_sizes  # the levels themselves: checked by RowPlan
    pt_out = torch.empty((P, TE), dtype=dt, device=dev)
    w = torch.empty((max(1, B), _PAD[dt][TF]), dtype=dt, device=dev)
    xcp = torch.empty((max(1, C), _PAD[dt][TF]), dtype=dt, device=dev)
    work = torch.empty((max(1, sum(sizes)), TF), dtype=dt, device=dev)
    cam_out = torch.empty((C, TF), dtype=dt, device=dev)
    _launch(fn, _ptr(JT), B, C, _ptr(plan.cam_idx), _ptr(plan.pt_idx),
            _ptr(plan.cam_pos), _ptr(plan.pt_start), _ptr(plan.pt_block),
            plan.n_pt_blocks, _ptr(xc), _ptr(xp), len(sizes),
            ctypes.cast(plan.cam_level_ptrs, ctypes.c_void_p),
            ctypes.cast(plan.cam_level_counts, ctypes.c_void_p),
            _ptr(plan.cam_level_first), _ptr(pt_out), _ptr(w), _ptr(xcp), _ptr(work),
            _ptr(cam_out), _stream(dev))
    normal_matvec.launches += 1
    return cam_out, pt_out


# --------------------------------------------------------------------------
# 4b. implicit_schur_matvec, mode="isc" (pallas_kernels.py:781, :1716)
# --------------------------------------------------------------------------


def isc_matvec_plain(JT, z, minv, plan, emit_u=False):
    Jf, Je = _split_jt(JT)
    pt = plan.pt_idx.long()
    fz = torch.einsum("bia,ba->bi", Jf, _camera_rows(plan, z))
    etfz = _point_sum(plan, torch.einsum("bik,bi->bk", Je, fz))
    u = (minv.reshape(-1, TE, TE) @ etfz.unsqueeze(2)).squeeze(2)
    q = fz - torch.einsum("bik,bk->bi", Je, u[pt])
    cam_out = _camera_sum(plan, torch.einsum("bia,bi->ba", Jf, q))
    return cam_out, (u if emit_u else None)


def isc_matvec(JT, z, minv, plan, emit_u=False):
    """The implicit Schur product without its D_f^2 term,
    S z = F'(F z - E M^{-1} E'F z), for z (C, 9) and per-point M^{-1}
    blocks minv (P, 9) row-major -> (cam (C, 9), u (P, 3) = M^{-1} E'F z
    when emit_u, else None)."""
    dev = JT.device
    if _on_cpu(JT):
        isc_matvec.plain_calls += 1
        return isc_matvec_plain(JT, z, minv, plan, emit_u)
    dt = _dtype_of(JT)
    fn = _entry("ct_isc_matvec", dt)
    B, P, C = plan.B, plan.P, plan.C
    _check(JT, "JT", dt, (LANES, B), dev)
    _check(z, "z", dt, (C, TF), dev)
    _check(minv, "minv", dt, (P, TE * TE), dev)
    _check_plan(plan, dev)
    _check_point_blocks(plan, dev)
    _check_cam_levels(plan, dev)
    sizes = plan.cam_level_sizes  # the levels themselves: checked by RowPlan
    u = torch.empty((P, TE) if emit_u else (1, TE), dtype=dt, device=dev)
    w = torch.empty((max(1, B), _PAD[dt][TF]), dtype=dt, device=dev)
    zp = torch.empty((max(1, C), _PAD[dt][TF]), dtype=dt, device=dev)
    work = torch.empty((max(1, sum(sizes)), TF), dtype=dt, device=dev)
    cam_out = torch.empty((C, TF), dtype=dt, device=dev)
    _launch(fn, _ptr(JT), B, C, _ptr(plan.cam_idx), _ptr(plan.cam_pos),
            _ptr(plan.pt_start), _ptr(plan.pt_block), plan.n_pt_blocks, _ptr(z),
            _ptr(minv), int(bool(emit_u)), len(sizes),
            ctypes.cast(plan.cam_level_ptrs, ctypes.c_void_p),
            ctypes.cast(plan.cam_level_counts, ctypes.c_void_p),
            _ptr(plan.cam_level_first), _ptr(u), _ptr(w), _ptr(zp), _ptr(work),
            _ptr(cam_out), _stream(dev))
    isc_matvec.launches += 1
    return cam_out, (u if emit_u else None)


# --------------------------------------------------------------------------
# 3b / 5. block-diag(S): schur_assembly, mode="schur_jacobi"
# (pallas_kernels.py:1281) and sj_assembly_windowed (pallas_kernels.py:2682)
# --------------------------------------------------------------------------


def schur_jacobi_blocks_plain(JT, se, minv, plan):
    Jf, Je = _split_jt(JT)
    pt = plan.pt_idx.long()
    ftf = torch.einsum("bia,bic->bac", Jf, Jf)
    W = se[pt][:, :, None] * torch.einsum("bik,bia->bka", Je, Jf)  # (B, 3, 9)
    Y = minv.reshape(-1, TE, TE)[pt] @ W
    corr = torch.einsum("bka,bkc->bac", W, Y)
    return _camera_sum(plan, (ftf - corr).reshape(-1, TF * TF))


def schur_jacobi_blocks(JT, se, minv, plan):
    """The camera blocks of the Schur complement without scales and D_f^2:
    (C, 81) row-major, block c = sum over the rows of camera c of
    J_f'J_f - W' M^{-1}[pt] W with W = diag(se[pt]) J_e'J_f (3 x 9); se
    (P, 3) point scales, minv (P, 9) row-major symmetric blocks (the
    kernel reads their upper triangles, forms each output block's upper
    triangle and mirrors it)."""
    dev = JT.device
    if _on_cpu(JT):
        schur_jacobi_blocks.plain_calls += 1
        return schur_jacobi_blocks_plain(JT, se, minv, plan)
    dt = _dtype_of(JT)
    fn = _entry("ct_schur_jacobi", dt)
    B, P, C = plan.B, plan.P, plan.C
    _check(JT, "JT", dt, (LANES, B), dev)
    _check(se, "se", dt, (P, TE), dev)
    _check(minv, "minv", dt, (P, TE * TE), dev)
    _check_plan(plan, dev)
    _check_point_blocks(plan, dev)
    _check_runs(plan, dev)
    w = torch.empty((max(1, plan.n_runs), _UPPER), dtype=dt, device=dev)
    work = torch.empty((max(1, sum(plan.run_level_sizes)), _UPPER), dtype=dt, device=dev)
    out = torch.empty((C, TF * TF), dtype=dt, device=dev)
    _launch(fn, _ptr(JT), B, C, _ptr(plan.pt_idx), _ptr(se), _ptr(minv),
            _ptr(plan.pt_start), _ptr(plan.pt_block), *_runs_args(plan), _ptr(w),
            _ptr(work), _ptr(out), _stream(dev))
    schur_jacobi_blocks.launches += 1
    return out


# --------------------------------------------------------------------------
# 6 / 9. segment_block_sum (pallas_kernels.py:228) and windowed_segment_sum
# (pallas_kernels.py:2563)
# --------------------------------------------------------------------------


def segment_block_sum_plain(contrib, plan):
    out = contrib.new_zeros((plan.num_keys, contrib.shape[1]))
    return out.index_add_(0, plan.ids.long(), contrib)


def _segment_sum(fn_name, contrib, plan, sorted_ids):
    dev = contrib.device
    dt = _dtype_of(contrib)
    fn = _entry(fn_name, dt)
    if contrib.dim() != 2:
        raise ValueError("contrib must be (B, w)")
    if (plan.order is None) != sorted_ids:
        raise ValueError("sorted ids go to segment_block_sum, unsorted ids to "
                         "unsorted_segment_sum")
    B, w = plan.B, contrib.shape[1]
    K = plan.num_keys
    i32 = torch.int32
    _check(contrib, "contrib", dt, (B, w), dev)
    out = torch.empty((K, w), dtype=dt, device=dev)
    if not sorted_ids:  # the gather by key
        _check(plan.order, "plan.order", i32, (B,), dev)
        _check(plan.key_first, "plan.key_first", i32, (K + 1,), dev)
        sizes = plan.level_sizes  # the levels themselves: checked by SegmentPlan
        work = torch.empty((max(1, sum(sizes)), w), dtype=dt, device=dev)
        _launch(fn, _ptr(contrib), B, w, _ptr(plan.order), len(sizes),
                ctypes.cast(plan.level_ptrs, ctypes.c_void_p),
                ctypes.cast(plan.level_counts, ctypes.c_void_p),
                _ptr(plan.key_first), K, _ptr(work), _ptr(out), _stream(dev))
        return out
    _check(plan.tile_run, "plan.tile_run", i32, (-(-B // SEG_TILE) + 1,), dev)
    _check(plan.run_start, "plan.run_start", i32, (plan.n_runs + 1,), dev)
    _check(plan.run_dest, "plan.run_dest", i32, (plan.n_runs,), dev)
    _check(plan.empty_keys, "plan.empty_keys", i32, (plan.n_empty,), dev)
    _check(plan.fin_first, "plan.fin_first", i32, (plan.n_fin + 1,), dev)
    _check(plan.fin_keys, "plan.fin_keys", i32, (plan.n_fin,), dev)
    sizes = plan.run_level_sizes  # the levels themselves: checked by SegmentPlan
    work = torch.empty((max(1, plan.n_partials + sum(sizes)), w), dtype=dt, device=dev)
    on = staged(plan, w, contrib.element_size(), _resident_blocks(dev, dt, w))
    _launch(fn, _ptr(contrib), B, w, int(on),
            _ptr(plan.tile_run), _ptr(plan.run_start), _ptr(plan.run_dest),
            plan.n_partials, _ptr(plan.empty_keys), plan.n_empty, len(sizes),
            ctypes.cast(plan.run_level_ptrs, ctypes.c_void_p),
            ctypes.cast(plan.run_level_counts, ctypes.c_void_p), _ptr(plan.fin_first),
            _ptr(plan.fin_keys), plan.n_fin, _ptr(work), _ptr(out), _stream(dev))
    return out


_RESIDENT = {}


def _resident_blocks(dev, dt, w: int) -> int:
    """The blocks of segment_block_sum's staged pass at width w that the
    card holds at once: its multiprocessors times the blocks of that kernel
    one holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor), once a
    process."""
    key = (str(dev), dt, w)
    if key not in _RESIDENT:
        n = ctypes.c_int(0)
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        _launch(_entry("ct_segment_block_sum_resident", dt), index, w, ctypes.byref(n))
        _RESIDENT[key] = n.value
    return _RESIDENT[key]


def staged(plan, w: int, itemsize: int, resident: int) -> bool:
    """Whether segment_block_sum's tile pass stages its rows, STAGED_TILES
    tiles a block (rows of at most STAGE_ROW_BYTES), or sums them in place,
    a tile a block: in place where the staged grid would not fill the card
    (fewer blocks than the `resident` ones it holds at once) and each
    thread would sum more than two (run, column) items in turn (libmv16's
    w = 15 in float32)."""
    if w * itemsize > STAGE_ROW_BYTES:
        return False
    n_tiles = plan.tile_run.shape[0] - 1
    items = plan.n_runs * w * STAGED_TILES  # (run, column) items of a block, n_tiles times
    return -(-n_tiles // STAGED_TILES) >= resident or items <= 2 * 256 * n_tiles


def segment_block_sum(contrib, plan):
    """out (K, w), out[k] = sum of the rows of contrib (B, w) whose id is
    k, for ids sorted (plan.order is None); K = plan.num_keys. The runs of
    one id within each tile of SEG_TILE rows (an id that ends at most
    SEG_HALO rows past the tile of its first row: one run of that tile),
    summed in the tile."""
    if _on_cpu(contrib):
        segment_block_sum.plain_calls += 1
        return segment_block_sum_plain(contrib, plan)
    out = _segment_sum("ct_segment_block_sum", contrib, plan, True)
    segment_block_sum.launches += 1
    return out


unsorted_segment_sum_plain = segment_block_sum_plain


def unsorted_segment_sum(contrib, plan):
    """segment_block_sum for ids in any order (replaces
    windowed_segment_sum): each id's rows gathered through the plan's
    stable order of the rows by id, a warp to a chunk of them."""
    if _on_cpu(contrib):
        unsorted_segment_sum.plain_calls += 1
        return unsorted_segment_sum_plain(contrib, plan)
    out = _segment_sum("ct_unsorted_segment_sum", contrib, plan, False)
    unsorted_segment_sum.launches += 1
    return out


# --------------------------------------------------------------------------
# 7. segment_block_expand (pallas_kernels.py:354)
# --------------------------------------------------------------------------


def segment_block_expand_plain(vals, ids):
    return torch.index_select(vals, 0, ids)


def segment_block_expand(vals, ids):
    """out (N, t), out[i] = vals[ids[i]] for a table vals (K, t) and ids
    (N,) int32 in any order."""
    dev = vals.device
    if _on_cpu(vals):
        segment_block_expand.plain_calls += 1
        return segment_block_expand_plain(vals, ids)
    dt = _dtype_of(vals)
    fn = _entry("ct_segment_block_expand", dt)
    if vals.dim() != 2 or ids.dim() != 1:
        raise ValueError("vals must be (K, t) and ids (N,)")
    K, t = vals.shape
    N = ids.shape[0]
    _check(vals, "vals", dt, (K, t), dev)
    _check(ids, "ids", torch.int32, (N,), dev)
    out = torch.empty((N, t), dtype=dt, device=dev)
    _launch(fn, _ptr(vals), K, t, _ptr(ids), N, _ptr(out), _stream(dev))
    segment_block_expand.launches += 1
    return out


# --------------------------------------------------------------------------
# 8 / 8J. segment_spread_sum without and with Jc (pallas_kernels.py:462;
# the Jc form's pallas_call at :734)
# --------------------------------------------------------------------------


def _sentinel_cams(cam_ids, C):
    """cam_ids as int64 with every id outside [0, C) set to C (the
    sentinel of a constant camera)."""
    cam = cam_ids.long()
    return torch.where((cam >= 0) & (cam < C), cam, C)


def segment_spread_sum_plain(Y, cam_ids, pt_start, C, te, tf):
    P = pt_start.shape[0] - 1
    n = int(pt_start[-1])
    pt = torch.repeat_interleave(torch.arange(P, device=Y.device),
                                 pt_start[1:] - pt_start[:-1])
    A = Y.new_zeros((P, C + 1, te, tf))  # column C takes the sentinel cameras
    A.index_put_((pt, _sentinel_cams(cam_ids[:n], C)), Y[:n].reshape(n, te, tf),
                 accumulate=True)
    return A[:, :C].permute(0, 2, 1, 3).reshape(P, te * C * tf)


def _check_spread(Y, cam_ids, pt_start, te, tf):
    dt = _dtype_of(Y)
    B = Y.shape[0]
    P = pt_start.shape[0] - 1
    _check(Y, "Y", dt, (B, te * tf), Y.device)
    _check(cam_ids, "cam_ids", torch.int32, (B,), Y.device)
    _check(pt_start, "pt_start", torch.int32, (P + 1,), Y.device)
    return dt, B, P


def segment_spread_sum(Y, cam_ids, pt_start, C, te, tf, Jc=None, r=2, plan=None):
    """The dense-Schur A of one camera-side slot: out (P, te*C*tf) with
    out[p, i*C*tf + c*tf + j] = sum over the rows b of point p of
    Y[b, i*tf + j] [cam_ids[b] == c]. Y (B, te*tf) and cam_ids (B,) int32
    have their rows sorted by point; the rows of point p are
    pt_start[p] .. pt_start[p+1] (pt_start (P+1,) int32; rows past
    pt_start[P] belong to no point); a camera id outside [0, C) adds
    nothing.

    With Jc (B, r*tf), the scaled camera Jacobian rows, returns (A, ftf)
    from kernel 8J instead (segment_spread_ftf, counted there)."""
    if Jc is not None:
        return segment_spread_ftf(Y, cam_ids, pt_start, C, te, tf, Jc, r, plan)
    if _on_cpu(Y):
        segment_spread_sum.plain_calls += 1
        return segment_spread_sum_plain(Y, cam_ids, pt_start, C, te, tf)
    dev = Y.device
    dt, B, P = _check_spread(Y, cam_ids, pt_start, te, tf)
    fn = _entry("ct_segment_spread_sum", dt)
    out = torch.empty((P, te * C * tf), dtype=dt, device=dev)
    _launch(fn, _ptr(Y), _ptr(cam_ids), _ptr(pt_start), P, C, te, tf, _ptr(out),
            _stream(dev))
    segment_spread_sum.launches += 1
    return out


def segment_spread_ftf_plain(Y, cam_ids, pt_start, C, te, tf, Jc, r, plan=None):
    """Takes the kernel's arguments, so that the two are called alike; the
    row plan's camera runs are the kernel's own and not needed here."""
    Jq = Jc.reshape(-1, r, tf)
    outer = torch.einsum("bqi,bqj->bij", Jq, Jq).reshape(-1, tf * tf)
    ftf = Y.new_zeros((C + 1, tf * tf)).index_add_(0, _sentinel_cams(cam_ids, C), outer)
    return segment_spread_sum_plain(Y, cam_ids, pt_start, C, te, tf), ftf[:C]


def segment_spread_ftf(Y, cam_ids, pt_start, C, te, tf, Jc, r, plan):
    """Kernel 8J: segment_spread_sum's A and the camera Gram blocks ftf
    (C, tf*tf), ftf[c, i*tf + j] = sum over every row b with cam_ids[b] ==
    c of sum_{q<r} Jc[b, q*tf + i] Jc[b, q*tf + j], for Jc (B, r*tf), the
    scaled camera Jacobian rows. Returns (A, ftf). The kernel takes r = 2
    rows of tf = 9 camera columns (the Snavely camera of the specialized
    pipeline) and sums the blocks by the camera runs of `plan`, a
    flatops.RowPlan over these rows (plan.cam_idx: cam_ids), which the
    plain version does not need."""
    if _on_cpu(Y):
        segment_spread_ftf.plain_calls += 1
        return segment_spread_ftf_plain(Y, cam_ids, pt_start, C, te, tf, Jc, r, plan)
    dev = Y.device
    dt, B, P = _check_spread(Y, cam_ids, pt_start, te, tf)
    fn = _entry("ct_segment_spread_ftf", dt)
    if (r, tf) != (R, TF):
        raise ValueError(f"the spread kernel forms F'F of r = {R} Jc rows of tf = {TF} "
                         f"camera columns, not r = {r}, tf = {tf}")
    if plan is None:
        raise ValueError("the Jc form needs the camera runs of a flatops.RowPlan")
    if (plan.B, plan.C) != (B, C):
        raise ValueError(f"the row plan covers {plan.B} rows of {plan.C} cameras, "
                         f"not {B} of {C}")
    _check(Jc, "Jc", dt, (B, r * tf), dev)
    _check(plan.pt_start, "plan.pt_start", torch.int32, (plan.P + 1,), dev)
    _check_point_blocks(plan, dev)
    _check_runs(plan, dev)
    out = torch.empty((P, te * C * tf), dtype=dt, device=dev)
    w = torch.empty((max(1, plan.n_runs), _UPPER), dtype=dt, device=dev)
    work = torch.empty((max(1, sum(plan.run_level_sizes)), _UPPER), dtype=dt, device=dev)
    ftf = torch.empty((C, TF * TF), dtype=dt, device=dev)
    # the kernel forks onto a second stream of the current device
    with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
        _launch(fn, _ptr(Y), _ptr(cam_ids), _ptr(pt_start), P, C, te, tf, _ptr(out),
                _ptr(Jc), _ptr(plan.pt_start), _ptr(plan.pt_block), *_runs_args(plan),
                _ptr(w), _ptr(work), _ptr(ftf), _stream(dev))
    segment_spread_ftf.launches += 1
    return out, ftf


KERNELS = (eval_fused, eval_fused_loss, eval_fused_quat, post_eval_fused, schur_assembly, normal_matvec,
           isc_matvec, schur_jacobi_blocks, segment_block_sum,
           segment_block_expand, segment_spread_sum, segment_spread_ftf,
           unsorted_segment_sum)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.plain_calls = 0


reset_counts()
