"""The jt-mode dense-Schur operations over flat tensors (counterpart of
ceres_tpu/ops/flatops.py, for the parts the dense path uses).

The JAX module plans 128-lane row tiles, gather bases and streamed mask
planes to satisfy TPU alignment; none of that carries over. What the CUDA
kernels need instead is the row plan (`RowPlan`): rows sorted by point
with the point segments, a camera plan (the rows ordered by camera, cut
into chunks that never cross a camera) and a point-pair plan for the
dense Schur assembly. It is structure-constant, built once per compiled
program with numpy and moved to the device.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import kernels as kn
from . import partition as pt
from ..types import not_ported


# --------------------------------------------------------------------------
# The row plan
# --------------------------------------------------------------------------


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
    pair_a: torch.Tensor  # (NP,) int32 rows; (a, b) share a point
    pair_b: torch.Tensor
    pair_chunk_start: torch.Tensor  # (m+1,) int32 offsets into the pairs
    pair_chunk_first: torch.Tensor  # (C*C+1,) int32 first chunk of each camera pair

    @property
    def n_cam_chunks(self) -> int:
        return self.cam_chunk_start.shape[0] - 1

    @property
    def n_pair_chunks(self) -> int:
        return self.pair_chunk_start.shape[0] - 1


def _chunks(keys_sorted: np.ndarray, num_keys: int, chunk: int):
    """Chunk offsets over a key-sorted list: each key's run is cut into
    pieces of at most `chunk` items. Returns (chunk_start (n+1,),
    chunk_first (num_keys+1,))."""
    counts = np.bincount(keys_sorted, minlength=num_keys).astype(np.int64)
    per_key = -(-counts // chunk)
    chunk_first = np.concatenate([[0], np.cumsum(per_key)])
    key_start = np.concatenate([[0], np.cumsum(counts)])
    n = int(chunk_first[-1])
    owner = np.repeat(np.arange(num_keys), per_key)
    j = np.arange(n) - chunk_first[owner]
    starts = key_start[owner] + j * chunk
    chunk_start = np.concatenate([starts, [len(keys_sorted)]])
    return chunk_start, chunk_first


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
    # every ordered pair (a, b) of rows of one point, by camera pair
    m = counts[pt_idx]
    pair_a = np.repeat(np.arange(B), m)
    first = np.concatenate([[0], np.cumsum(m)])[:-1]
    local = np.arange(pair_a.shape[0]) - np.repeat(first, m)
    pair_b = pt_start[pt_idx[pair_a]] + local
    key = cam_idx[pair_a] * C + cam_idx[pair_b]
    order = np.argsort(key, kind="stable")
    pair_a, pair_b, key = pair_a[order], pair_b[order], key[order]
    pair_cs, pair_cf = _chunks(key, C * C, kn.CHUNK)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    return RowPlan(B, P, C, dev(pt_idx), dev(cam_idx), dev(pt_start),
                   dev(cam_rows), dev(cam_cs), dev(cam_cf), dev(pair_a),
                   dev(pair_b), dev(pair_cs), dev(pair_cf))


# --------------------------------------------------------------------------
# Flat-lane block algebra
# --------------------------------------------------------------------------


def chol_inv_lower_flat(M: torch.Tensor, t: int) -> torch.Tensor:
    """K = L^{-1} (lower triangular, upper entries zero) of SPD blocks
    stored as (N, t*t) row-major rows. Closed form for t = 3, in float64
    internally: the small-pivot recurrences cancel badly in float32."""
    if t != 3:
        raise ValueError("the closed form takes 3x3 blocks")
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
    z = torch.zeros_like(K11)
    return torch.stack([K11, z, z, K21, K22, z, K31, K32, K33], dim=1).to(M.dtype)


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
            raise not_ported("programs other than one two-slot residual kind", 6)
        if len(pm.e_fams) != 1 or len(pm.f_fams) != 1:
            raise not_ported("more than one e or f family", 6)
        kind = kinds[0]
        e_fi, f_fi = pm.e_family_indices[0], pm.f_family_indices[0]
        self.se = next(i for i, s in enumerate(kind.slots) if s.family_index == e_fi)
        self.sf = next(i for i, s in enumerate(kind.slots) if s.family_index == f_fi)
        fe, ff = pm.base.families[e_fi], pm.base.families[f_fi]
        if (kind.r, ff.t, fe.t) != (kn.R, kn.TF, kn.TE):
            raise not_ported(
                f"residual/camera/point sizes {(kind.r, ff.t, fe.t)} "
                f"(the kernels take {(kn.R, kn.TF, kn.TE)})", 6)
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
            raise not_ported("costs without residual_rows in the fused path", 6)
        if kind.data is None or tuple(kind.data.shape) != (kind.B, kn.R):
            raise not_ported("observation data other than (B, 2)", 6)
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

    # -- the normal-equation product (pallas_kernels.normal_matvec) --------

    def make_kernel_suite_raw(self, JT, se, sf):
        """Scale-folded (J_s'J_s) x over the unscaled JT: the Jacobi scales
        fold into the small operands. Returns normal(xc, xp_rows) ->
        (F_s' J_s x (C*9,), E_s' J_s x (P, 3)) for x = [xc; xp] in scaled
        coordinates."""
        P, C = self.P, self.C
        se_rows = se.reshape(P, kn.TE)
        sf_rows = sf.reshape(C, kn.TF)

        def normal(xc, xp_rows):
            cam, ptv = kn.normal_matvec(
                JT, (sf_rows * xc.reshape(C, kn.TF)).contiguous(),
                (xp_rows * se_rows).contiguous(), self.plan)
            return (sf_rows * cam).reshape(-1), ptv * se_rows

        return normal
