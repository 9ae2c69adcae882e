"""The four kernels of the dense-Schur jt-mode path (counterpart of
ceres_tpu/ops/pallas_kernels.py).

Each wrapper takes tensors on one device. On the CPU it runs the kernel's
plain PyTorch version; on a CUDA device it launches the hand-written CUDA
kernel (csrc/*.cu, built by ops/build.py) on the current stream, or raises:
there is no fallback from one to the other. Each wrapper carries two plain
integers: `launches`, counted where the CUDA kernel is launched, and
`plain_calls`, counted where the plain version runs.

Shapes are those of the Snavely BA path: r = 2 residual rows, tf = 9
camera and te = 3 point tangent columns. J travels transposed, as JT
(24, B) (layout in csrc/common.cuh), residuals as rT (2, B). The `plan`
argument is a flatops.RowPlan: rows sorted by point, the point segments,
the camera chunk plan and, for schur_assembly, the point-pair plan.
"""
from __future__ import annotations

import ctypes

import torch

R, TF, TE = 2, 9, 3
LANES = R * (TF + TE)
E_OFF = R * TF
CHUNK = 64  # rows (or pairs) per chunk; CT_CHUNK in csrc/common.cuh
_PT_OUT = 2 * TE + TE * TE
_CAM_OUT = 2 * TF

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
    i32 = torch.int32
    B, P, C = plan.B, plan.P, plan.C
    _check(plan.cam_idx, "plan.cam_idx", i32, (B,), device)
    _check(plan.pt_idx, "plan.pt_idx", i32, (B,), device)
    _check(plan.pt_start, "plan.pt_start", i32, (P + 1,), device)
    _check(plan.cam_rows, "plan.cam_rows", i32, (B,), device)
    _check(plan.cam_chunk_start, "plan.cam_chunk_start", i32,
           (plan.n_cam_chunks + 1,), device)
    _check(plan.cam_chunk_first, "plan.cam_chunk_first", i32, (C + 1,), device)


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
    out = contrib.new_zeros((plan.C,) + tuple(contrib.shape[1:]))
    return out.index_add_(0, plan.cam_idx.long(), contrib)


def _point_sum(plan, contrib: torch.Tensor) -> torch.Tensor:
    out = contrib.new_zeros((plan.P,) + tuple(contrib.shape[1:]))
    return out.index_add_(0, plan.pt_idx.long(), contrib)


# --------------------------------------------------------------------------
# 1. eval_fused (pallas_kernels.py:2066)
# --------------------------------------------------------------------------


def eval_fused_plain(cams, pts, obs, plan, rows_fn):
    """Residuals, exact Jacobian (forward-mode autodiff of `rows_fn`) and
    the f64 sum of squared residuals."""
    c = cams[plan.cam_idx.long()]
    p = pts[plan.pt_idx.long()]

    def one(ci, pi, oi):
        return rows_fn(ci, pi, oi)

    jac = torch.func.vmap(torch.func.jacfwd(one, argnums=(0, 1)))
    Jc, Jp = jac(c, p, obs)  # (B, 2, 9), (B, 2, 3)
    res = torch.func.vmap(one)(c, p, obs)  # (B, 2)
    B = obs.shape[0]
    JT = torch.cat([Jc.permute(1, 2, 0).reshape(E_OFF, B),
                    Jp.permute(1, 2, 0).reshape(R * TE, B)], dim=0)
    cost = torch.sum(torch.sum(res * res, dim=1).to(torch.float64)).reshape(1)
    return cost, res.T.contiguous(), JT.contiguous()


def eval_fused(cams, pts, obs, plan, rows_fn):
    """(cost (1,) f64 = sum |r|^2, rT (2, B), JT (24, B)) of the Snavely
    residual at cameras (C, 9), points (P, 3), observations (B, 2)."""
    dev = cams.device
    if _on_cpu(cams):
        eval_fused.plain_calls += 1
        return eval_fused_plain(cams, pts, obs, plan, rows_fn)
    from ..models.bal import snavely_residual_rows

    if rows_fn is not snavely_residual_rows:
        raise NotImplementedError(
            "the eval_fused CUDA kernel computes snavely_residual_rows only")
    dt = _dtype_of(cams)
    fn = _entry("ct_eval_fused", dt)
    B, P, C = plan.B, plan.P, plan.C
    _check(cams, "cams", dt, (C, TF), dev)
    _check(pts, "pts", dt, (P, TE), dev)
    _check(obs, "obs", dt, (B, R), dev)
    _check(plan.cam_idx, "plan.cam_idx", torch.int32, (B,), dev)
    _check(plan.pt_idx, "plan.pt_idx", torch.int32, (B,), dev)
    rT = torch.empty((R, B), dtype=dt, device=dev)
    JT = torch.empty((LANES, B), dtype=dt, device=dev)
    partial = torch.empty((max(1, -(-B // 256)),), dtype=torch.float64, device=dev)
    cost = torch.empty((1,), dtype=torch.float64, device=dev)
    _launch(fn, _ptr(cams), _ptr(pts), _ptr(obs),
            _ptr(plan.cam_idx), _ptr(plan.pt_idx), B, _ptr(rT), _ptr(JT),
            _ptr(partial), _ptr(cost), _stream(dev))
    eval_fused.launches += 1
    return cost, rT, JT


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
    ptab = torch.empty((P, _PT_OUT), dtype=dt, device=dev)
    cam_partial = torch.empty((max(1, plan.n_cam_chunks), _CAM_OUT), dtype=dt,
                              device=dev)
    cam = torch.empty((C, _CAM_OUT), dtype=dt, device=dev)
    _launch(fn, _ptr(JT), _ptr(rT), B, P, C,
            _ptr(plan.pt_start), _ptr(plan.cam_rows), _ptr(plan.cam_chunk_start),
            plan.n_cam_chunks, _ptr(plan.cam_chunk_first), _ptr(ptab),
            _ptr(cam_partial), _ptr(cam), _stream(dev))
    post_eval_fused.launches += 1
    return ptab, cam


# --------------------------------------------------------------------------
# 3. schur_assembly, mode="dense" (pallas_kernels.py:1281)
# --------------------------------------------------------------------------


def schur_assembly_plain(JT, sc, sp, K, u, plan):
    """Straight from the definition: the dense A (P*3, C*9) of the
    eliminated system, then A'A and A'u."""
    Jf, Je = _split_jt(JT)
    cam = plan.cam_idx.long()
    pt = plan.pt_idx.long()
    Jsf = Jf * sc[cam][:, None, :]
    Jsp = Je * sp[pt][:, None, :]
    W = torch.einsum("bik,bia->bka", Jsp, Jsf)  # (B, 3, 9)
    Y = torch.einsum("bmk,bka->bma", K.reshape(-1, TE, TE)[pt], W)
    P, C = plan.P, plan.C
    A = JT.new_zeros((P, C, TE, TF))
    A.index_put_((pt, cam), Y, accumulate=True)
    A = A.permute(0, 2, 1, 3).reshape(P * TE, C * TF)
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
    i32 = torch.int32
    NP = plan.pair_a.shape[0]
    _check(plan.pair_a, "plan.pair_a", i32, (NP,), dev)
    _check(plan.pair_b, "plan.pair_b", i32, (NP,), dev)
    _check(plan.pair_chunk_start, "plan.pair_chunk_start", i32,
           (plan.n_pair_chunks + 1,), dev)
    _check(plan.pair_chunk_first, "plan.pair_chunk_first", i32, (C * C + 1,), dev)
    t_full = C * TF
    Y = torch.empty((TE * TF, B), dtype=dt, device=dev)
    cam_partial = torch.empty((max(1, plan.n_cam_chunks), TF * TF + TF),
                              dtype=dt, device=dev)
    pair_partial = torch.empty((max(1, plan.n_pair_chunks), TF * TF), dtype=dt,
                               device=dev)
    ata = torch.empty((t_full, t_full), dtype=dt, device=dev)
    ftf = torch.empty((C, TF * TF), dtype=dt, device=dev)
    U = torch.empty((t_full,), dtype=dt, device=dev)
    _launch(fn, _ptr(JT), B, P, C,
            _ptr(plan.cam_idx), _ptr(plan.pt_idx), _ptr(sc), _ptr(sp), _ptr(K),
            _ptr(u), _ptr(plan.cam_rows), _ptr(plan.cam_chunk_start),
            plan.n_cam_chunks, _ptr(plan.cam_chunk_first), _ptr(plan.pair_a),
            _ptr(plan.pair_b), _ptr(plan.pair_chunk_start), plan.n_pair_chunks,
            _ptr(plan.pair_chunk_first), _ptr(Y), _ptr(cam_partial),
            _ptr(pair_partial), _ptr(ata), _ptr(ftf), _ptr(U), _stream(dev))
    schur_assembly.launches += 1
    return ata, ftf, U


# --------------------------------------------------------------------------
# 4. implicit_schur_matvec, mode="normal" (pallas_kernels.py:781, :1759)
# --------------------------------------------------------------------------


def normal_matvec_plain(JT, xc, xp, plan):
    Jf, Je = _split_jt(JT)
    cam = plan.cam_idx.long()
    pt = plan.pt_idx.long()
    jv = torch.einsum("bia,ba->bi", Jf, xc[cam]) + torch.einsum(
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
    pt_out = torch.empty((P, TE), dtype=dt, device=dev)
    cam_partial = torch.empty((max(1, plan.n_cam_chunks), TF), dtype=dt,
                              device=dev)
    cam_out = torch.empty((C, TF), dtype=dt, device=dev)
    _launch(fn, _ptr(JT), B, P, C,
            _ptr(plan.cam_idx), _ptr(plan.pt_idx), _ptr(plan.pt_start),
            _ptr(plan.cam_rows), _ptr(plan.cam_chunk_start), plan.n_cam_chunks,
            _ptr(plan.cam_chunk_first), _ptr(xc), _ptr(xp), _ptr(pt_out),
            _ptr(cam_partial), _ptr(cam_out), _stream(dev))
    normal_matvec.launches += 1
    return cam_out, pt_out


KERNELS = (eval_fused, post_eval_fused, schur_assembly, normal_matvec)


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.plain_calls = 0


reset_counts()
