"""The jt-mode Schur operations over flat tensors (counterpart of
ceres_tpu/ops/flatops.py, for the parts the dense and iterative Schur
paths use).

The JAX module plans 128-lane row tiles, gather bases, camera windows and
streamed mask planes to satisfy TPU alignment; none of that carries over.
What the CUDA kernels need instead is the row plan (`RowPlan`): rows
sorted by point with the point segments, and a camera plan (the rows
ordered by camera, cut into chunks that never cross a camera). Only the
dense Schur assembly also needs the point-pair plan, which holds every
ordered pair of rows of one point and a C*C-entry chunk index: it is built
on request (`RowPlan.ensure_pairs`), never for the iterative path, whose
camera count can make it gigabytes. The plan is structure-constant, built
once per compiled program with numpy and moved to the device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import kernels as kn
from . import partition as pt
from ..types import not_ported


# --------------------------------------------------------------------------
# The row plan
# --------------------------------------------------------------------------


class PairPlan(NamedTuple):
    pair_a: torch.Tensor  # (NP,) int32 rows; (a, b) share a point
    pair_b: torch.Tensor
    pair_chunk_start: torch.Tensor  # (m+1,) int32 offsets into the pairs
    pair_chunk_first: torch.Tensor  # (C*C+1,) int32 first chunk of each camera pair


@dataclasses.dataclass
class RowPlan:
    B: int
    P: int
    C: int
    pt_idx: torch.Tensor  # (B,) int32, nondecreasing
    cam_idx: torch.Tensor  # (B,) int32
    pt_start: torch.Tensor  # (P+1,) int32: rows of point p are [p], [p+1])
    cam_rows: torch.Tensor  # (B,) int32: rows ordered by camera (stable)
    cam_chunk_start: torch.Tensor  # (n+1,) int32 offsets into cam_rows
    cam_chunk_first: torch.Tensor  # (C+1,) int32 first chunk of each camera
    pairs: Optional[PairPlan] = None  # the dense-Schur pair plan, on request

    @property
    def n_cam_chunks(self) -> int:
        return self.cam_chunk_start.shape[0] - 1

    def ensure_pairs(self) -> PairPlan:
        """The point-pair plan, built on first request."""
        if self.pairs is None:
            self.pairs = _build_pair_plan(self.pt_idx.cpu().numpy(),
                                          self.cam_idx.cpu().numpy(),
                                          self.pt_start.cpu().numpy(), self.C,
                                          self.pt_idx.device)
        return self.pairs


def _chunks(keys_sorted: np.ndarray, num_keys: int, chunk: int):
    """Chunk offsets over a key-sorted list: each key's run is cut into
    pieces of at most `chunk` items. Returns (chunk_start (n+1,),
    chunk_first (num_keys+1,)), int64."""
    counts = np.bincount(keys_sorted, minlength=num_keys).astype(np.int64)
    per_key = -(-counts // chunk)
    chunk_first = np.concatenate([[0], np.cumsum(per_key)])
    key_start = np.concatenate([[0], np.cumsum(counts)])
    n = int(chunk_first[-1])
    owner = np.repeat(np.arange(num_keys, dtype=np.int64), per_key)
    j = np.arange(n, dtype=np.int64) - chunk_first[owner]
    starts = key_start[owner] + j * chunk
    chunk_start = np.concatenate([starts, [len(keys_sorted)]])
    return chunk_start, chunk_first


def _dev_i32(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.size and (a.min() < 0 or a.max() > np.iinfo(np.int32).max):
        raise ValueError("a plan index does not fit int32")
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)


def build_row_plan(pt_idx: np.ndarray, cam_idx: np.ndarray, P: int, C: int,
                   device) -> RowPlan:
    pt_idx = np.asarray(pt_idx, np.int64)
    cam_idx = np.asarray(cam_idx, np.int64)
    if np.any(pt_idx[1:] < pt_idx[:-1]):
        raise ValueError("the row plan needs rows sorted by point")
    B = pt_idx.shape[0]
    counts = np.bincount(pt_idx, minlength=P)
    pt_start = np.concatenate([[0], np.cumsum(counts)])
    cam_rows = np.argsort(cam_idx, kind="stable")
    cam_cs, cam_cf = _chunks(cam_idx[cam_rows], C, kn.CHUNK)

    def dev(a):
        return _dev_i32(a, device)

    return RowPlan(B, P, C, dev(pt_idx), dev(cam_idx), dev(pt_start),
                   dev(cam_rows), dev(cam_cs), dev(cam_cf))


def _build_pair_plan(pt_idx, cam_idx, pt_start, C: int, device) -> PairPlan:
    """Every ordered pair (a, b) of rows of one point, ordered by camera
    pair (cam[a], cam[b]) and cut into chunks of one camera pair each."""
    pt_idx = np.asarray(pt_idx, np.int64)
    cam_idx = np.asarray(cam_idx, np.int64)
    pt_start = np.asarray(pt_start, np.int64)
    B = pt_idx.shape[0]
    m = (pt_start[1:] - pt_start[:-1])[pt_idx]
    pair_a = np.repeat(np.arange(B, dtype=np.int64), m)
    first = np.concatenate([[0], np.cumsum(m)])[:-1]
    local = np.arange(pair_a.shape[0], dtype=np.int64) - np.repeat(first, m)
    pair_b = pt_start[pt_idx[pair_a]] + local
    key = cam_idx[pair_a] * C + cam_idx[pair_b]
    order = np.argsort(key, kind="stable")
    pair_a, pair_b, key = pair_a[order], pair_b[order], key[order]
    pair_cs, pair_cf = _chunks(key, C * C, kn.CHUNK)
    return PairPlan(*(_dev_i32(a, device) for a in (pair_a, pair_b, pair_cs, pair_cf)))


# --------------------------------------------------------------------------
# Flat-lane block algebra
# --------------------------------------------------------------------------


def _chol3(M: torch.Tensor):
    """Closed-form Cholesky of SPD 3x3 blocks (N, 9) row-major, in float64:
    the small-pivot recurrences cancel badly in float32. Returns the
    inverse factor K = L^{-1} as its six lanes (K11, K21, K22, K31, K32,
    K33)."""
    m = M.to(torch.float64)
    a, b, c = m[:, 0], m[:, 1], m[:, 2]
    d, e, f = m[:, 4], m[:, 5], m[:, 8]
    L11 = torch.sqrt(a)
    L21 = b / L11
    L31 = c / L11
    L22 = torch.sqrt(d - L21 * L21)
    L32 = (e - L21 * L31) / L22
    L33 = torch.sqrt(f - L31 * L31 - L32 * L32)
    K11 = 1.0 / L11
    K22 = 1.0 / L22
    K33 = 1.0 / L33
    K21 = -L21 * K11 * K22
    K31 = (L21 * L32 - L31 * L22) * K11 * K22 * K33
    K32 = -L32 * K22 * K33
    return K11, K21, K22, K31, K32, K33


def chol_inv_lower_flat(M: torch.Tensor, t: int) -> torch.Tensor:
    """K = L^{-1} (lower triangular, upper entries zero) of SPD blocks
    stored as (N, t*t) row-major rows; closed form for t = 3."""
    if t != 3:
        raise ValueError("the closed form takes 3x3 blocks")
    K11, K21, K22, K31, K32, K33 = _chol3(M)
    z = torch.zeros_like(K11)
    return torch.stack([K11, z, z, K21, K22, z, K31, K32, K33], dim=1).to(M.dtype)


def spd_inverse_flat(M: torch.Tensor, t: int) -> torch.Tensor:
    """Inverses of SPD (t x t) blocks stored as (N, t*t) row-major rows
    (flatops.py:132). t = 3 in closed form, M^{-1} = K'K; larger t through
    a batched Cholesky (the JAX function is XLA there too). A block that is
    not positive definite comes out NaN, without a host sync, and the LM
    loop reads the step as invalid."""
    if t == 3:
        K11, K21, K22, K31, K32, K33 = _chol3(M)
        i11 = K11 * K11 + K21 * K21 + K31 * K31
        i12 = K21 * K22 + K31 * K32
        i13 = K31 * K33
        i22 = K22 * K22 + K32 * K32
        i23 = K32 * K33
        i33 = K33 * K33
        return torch.stack([i11, i12, i13, i12, i22, i23, i13, i23, i33],
                           dim=1).to(M.dtype)
    N = M.shape[0]
    L, info = torch.linalg.cholesky_ex(M.reshape(N, t, t))
    L = torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))
    eye = torch.eye(t, dtype=M.dtype, device=M.device).expand(N, t, t)
    K = torch.linalg.solve_triangular(L, eye, upper=False)
    return (K.transpose(1, 2) @ K).reshape(N, t * t)


def scaled_block_inverses(blocks: torch.Tensor, scale: torch.Tensor,
                          D2: torch.Tensor, t: int) -> torch.Tensor:
    """Inverses of S_b (J'J)_b S_b + diag(D2)_b per block (flatops.py:633):
    blocks (N, t*t), scale and D2 (N*t,) in the partition layout."""
    N = blocks.shape[0]
    s = scale.reshape(N, t)
    M = blocks * (s[:, :, None] * s[:, None, :]).reshape(N, t * t)
    M = M + torch.diag_embed(D2.reshape(N, t)).reshape(N, t * t)
    return spd_inverse_flat(M, t)


def apply_inverse_rows(inv: torch.Tensor, v: torch.Tensor, t: int) -> torch.Tensor:
    """x = blockdiag^{-1} v from inverse blocks (N, t*t) (flatops.py:648)."""
    N = inv.shape[0]
    return (inv.reshape(N, t, t) @ v.reshape(N, t, 1)).reshape(-1)


class JTQual(NamedTuple):
    """What qualifies a program for the fused jt-mode evaluation."""

    fam_f: object
    fam_e: object
    rows_fn: object


class FlatSchurOps:
    """The e/f partition of a one-kind, two-slot program (BA: cameras f,
    points e) with rows sorted by point, and its kernel plan. The row plan
    built here plays the part of the JAX `eval_invariants` (flatops.py:901):
    the structure-constant tensors the kernels read, built once; the
    observations stay in the program's kind data."""

    def __init__(self, pm: pt.PartitionedMeta, program):
        self.pm = pm
        kinds = pm.base.kinds
        if len(kinds) != 1 or len(kinds[0].slots) != 2:
            raise not_ported("programs other than one two-slot residual kind", 7)
        if len(pm.e_fams) != 1 or len(pm.f_fams) != 1:
            raise not_ported("more than one e or f family", 7)
        kind = kinds[0]
        e_fi, f_fi = pm.e_family_indices[0], pm.f_family_indices[0]
        self.se = next(i for i, s in enumerate(kind.slots) if s.family_index == e_fi)
        self.sf = next(i for i, s in enumerate(kind.slots) if s.family_index == f_fi)
        fe, ff = pm.base.families[e_fi], pm.base.families[f_fi]
        if (kind.r, ff.t, fe.t) != (kn.R, kn.TF, kn.TE):
            raise not_ported(
                f"residual/camera/point sizes {(kind.r, ff.t, fe.t)} "
                f"(the kernels take {(kn.R, kn.TF, kn.TE)})", 7)
        pt_local = kind.slots[self.se].block_ids - fe.block_id_offset
        cam_local = kind.slots[self.sf].block_ids - ff.block_id_offset
        self.P, self.C = fe.num_var, ff.num_var
        self.plan = build_row_plan(pt_local, cam_local, self.P, self.C,
                                   program.device)

    # -- evaluation (pallas_kernels.eval_fused) ----------------------------

    def eval_kernel_qual(self, program) -> JTQual:
        """The fused evaluation takes one kind whose cost carries a
        row-vectorized residual and a (B, 2) observation array (the
        program has already refused robust losses and manifolds)."""
        kind = program.kinds[0]
        rows_fn = getattr(kind.cost, "residual_rows", None)
        if rows_fn is None:
            raise not_ported("costs without residual_rows in the fused path", 7)
        if kind.data is None or tuple(kind.data.shape) != (kind.B, kn.R):
            raise not_ported("observation data other than (B, 2)", 7)
        fam_f = kind.slots[self.sf].family
        fam_e = kind.slots[self.se].family
        return JTQual(fam_f, fam_e, rows_fn)

    def eval_fused_x(self, program, q: JTQual, x: torch.Tensor):
        """Fused evaluation at state x: (cost f64 0-d, rT (2, B), JT (24, B))."""
        dt = program.compute_dtype
        cams = program.family_table(x, q.fam_f).to(dt).contiguous()
        pts = program.family_table(x, q.fam_e).to(dt).contiguous()
        kind = program.kinds[0]
        sq, rT, JT = kn.eval_fused(cams, pts, kind.data, self.plan, q.rows_fn)
        cost = 0.5 * sq[0] + program.fixed_cost
        return cost, rT, JT

    # -- post evaluation (pallas_kernels.post_eval_fused) ------------------

    def post_eval_kernel_jt(self, JT, rT):
        """(g_e, sqn_e, ete (P, 9), g_f, sqn_f) in partition layouts."""
        ptab, cam = kn.post_eval_fused(JT, rT, self.plan)
        te, tf = kn.TE, kn.TF
        g_e = ptab[:, :te].reshape(-1)
        sqn_e = ptab[:, te:2 * te].reshape(-1)
        ete = ptab[:, 2 * te:]
        g_f = cam[:, :tf].reshape(-1)
        sqn_f = cam[:, tf:].reshape(-1)
        return g_e, sqn_e, ete, g_f, sqn_f

    # -- the kernel suite (flatops.py:1014) ---------------------------------

    def make_kernel_suite_raw(self, JT, se, sf):
        """Scale-folded kernels over the unscaled JT: the Jacobi scales fold
        into the small operands (flatops.py:1014-1026):

          matvec:  S_s z = sf (.) F'(fz - E u'),  fz = F (sf (.) z),
                   u' = [se Minv_s se] E'fz      (fold_minv makes the fold)
          SJ:      blocks_s[c] = sf_c (x) sf_c (.) (F'F - W' Minv_s W)
                   with W = diag(se) E'F, plus D_f^2, inverted
          normal:  J_s'J_s x through pre-scaled inputs, post-scaled outputs

        Returns (matvec, jacobi_blocks, normal, fold_minv) over vectors in
        scaled coordinates: matvec(z, minv_folded, emit_u) -> (S z without
        its D_f^2 term (C*9,), u = Minv_s E_s'F_s z (P*3,) or None);
        jacobi_blocks(minv, d2f) -> (C, 81) inverses of the blocks of S;
        normal(xc, xp_rows) -> (F_s'J_s x (C*9,), E_s'J_s x (P, 3))."""
        P, C, te, tf = self.P, self.C, kn.TE, kn.TF
        se_rows = se.reshape(P, te)
        sf_rows = sf.reshape(C, tf)

        def fold_minv(minv):
            return (minv * (se_rows[:, :, None] * se_rows[:, None, :]).reshape(
                P, te * te)).contiguous()

        def matvec(z, minv_folded, emit_u=False):
            cam, u = kn.isc_matvec(JT, (sf_rows * z.reshape(C, tf)).contiguous(),
                                   minv_folded, self.plan, emit_u)
            cam = (sf_rows * cam).reshape(-1)
            return cam, (u / se_rows).reshape(-1) if emit_u else None

        def jacobi_blocks(minv, d2f):
            blocks = kn.schur_jacobi_blocks(JT, se_rows.contiguous(),
                                            minv.contiguous(), self.plan)
            blocks = blocks * (sf_rows[:, :, None] * sf_rows[:, None, :]).reshape(
                C, tf * tf)
            M = blocks + torch.diag_embed(d2f.reshape(C, tf)).reshape(C, tf * tf)
            return spd_inverse_flat(M, tf)

        def normal(xc, xp_rows):
            cam, ptv = kn.normal_matvec(
                JT, (sf_rows * xc.reshape(C, tf)).contiguous(),
                (xp_rows * se_rows).contiguous(), self.plan)
            return (sf_rows * cam).reshape(-1), ptv * se_rows

        return matvec, jacobi_blocks, normal, fold_minv
