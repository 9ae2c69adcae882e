"""DENSE_SCHUR: the reduced camera system assembled densely and factored
(counterpart of ceres_tpu/solvers/linear/dense_schur.py;
schur_complement_solver.cc:101-246).

    S = F'F + D_f^2 - W' (E'E + D_e^2)^{-1} W,   W = E'F

W (e_size, f_size) and F'F (f_size, f_size) are dense; each of their
blocks is the sum of the rows' products E_b'F_b (or F_b'F_b) over the
rows that share its pair of blocks. `DenseSchurOps`, built once per
program, holds on the device, for each pair of families, the rows in the
order of their block pair and the places of each pair's block in the
dense matrix: a step forms the row products in that order, sums each
pair's by segment_block_sum (kernel 6) and writes each block once. E'E,
E'b and F'b are FlatSchurOps's reductions (kernels 6 and 9). No sum runs
by atomics, so a step repeats bit for bit. S is then solved by Cholesky
and back-substituted. For up to a few thousand f-tangent dimensions.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ...ops import flatops as fo
from ...ops import kernels as kn
from ...ops import partition as pt
from .dense import cholesky_lower


class PairGroup(NamedTuple):
    """The blocks of W or F'F between one family a (rows of the dense
    matrix) and one family b (its columns)."""

    members: tuple  # (k, slot a, slot b, rows with both blocks variable or None for all)
    ta: int
    tb: int
    order: torch.Tensor  # (N,) int64: the members' rows, concatenated, by block pair
    seg: fo.SegmentPlan  # the sorted pair ids of `order`'s rows, over the U pairs
    rows: torch.Tensor  # (U, ta, 1) int64: each pair's block rows in the dense matrix
    cols: torch.Tensor  # (U, 1, tb) int64: and its columns


def _slots_by_family(pm: pt.PartitionedMeta, e: bool):
    """{partition family index: [(k, s, (B,) local block ids, nv for a
    constant block)]}."""
    out = {}
    for k, s, fi, local in pt.slot_layouts(pm, e):
        out.setdefault(fi, []).append((k, s, local))
    return out


def _pair_group(slots_a, slots_b, fam_a, fam_b, device) -> Optional[PairGroup]:
    """The PairGroup of every row of one kind that holds a variable block
    of family a and one of family b, or None where no row does."""
    off_a, nv_a, ta, _ = fam_a
    off_b, nv_b, tb, _ = fam_b
    members, keys = [], []
    for k, sa, la in slots_a:
        for k2, sb, lb in slots_b:
            if k2 != k:
                continue
            keep = (la < nv_a) & (lb < nv_b)
            if not keep.any():
                continue
            idx = np.flatnonzero(keep)
            members.append((k, sa, sb, None if keep.all()
                            else torch.as_tensor(idx, device=device)))
            keys.append(la[idx] * nv_b + lb[idx])
    if not members:
        return None
    keys = np.concatenate(keys)
    order = np.argsort(keys, kind="stable")
    pairs, ids = np.unique(keys[order], return_inverse=True)
    rows = off_a + (pairs // nv_b)[:, None] * ta + np.arange(ta)
    cols = off_b + (pairs % nv_b)[:, None] * tb + np.arange(tb)
    return PairGroup(tuple(members), ta, tb, torch.as_tensor(order, device=device),
                     fo.build_segment_plan(ids, len(pairs), device),
                     torch.as_tensor(rows[:, :, None], device=device),
                     torch.as_tensor(cols[:, None, :], device=device))


class DenseSchurOps:
    """The DENSE_SCHUR step's plans over a FlatSchurOps, built once per
    program: the pair groups of W (e, f) and of F'F (f, f)."""

    def __init__(self, pm: pt.PartitionedMeta, flat: fo.FlatSchurOps):
        self.pm = pm
        self.flat = flat
        dev = flat.device
        e, f = _slots_by_family(pm, True), _slots_by_family(pm, False)
        groups = [(_pair_group(e[a], f[b], pm.e_fams[a], pm.f_fams[b], dev), True)
                  for a in e for b in f]
        groups += [(_pair_group(f[a], f[b], pm.f_fams[a], pm.f_fams[b], dev), False)
                   for a in f for b in f]
        self.w_groups = [g for g, is_w in groups if g is not None and is_w]
        self.ftf_groups = [g for g, is_w in groups if g is not None and not is_w]

    def _assemble(self, groups, vflat, shape) -> torch.Tensor:
        """The dense matrix of the groups' blocks: each pair's row products
        summed by kernel 6 in the order of `order`, written once."""
        out = vflat[0][0].new_zeros(shape)
        kinds = self.flat.kinds
        for g in groups:
            parts = []
            for k, sa, sb, idx in g.members:
                B, r = kinds[k].B, kinds[k].r
                Ja = vflat[k][sa].reshape(B, r, g.ta)
                Jb = vflat[k][sb].reshape(B, r, g.tb)
                if idx is not None:
                    Ja, Jb = Ja[idx], Jb[idx]
                parts.append(fo.small_matmul(Ja.transpose(1, 2), Jb).reshape(Ja.shape[0], -1))
            prods = torch.cat(parts)[g.order]
            sums = kn.segment_block_sum(prods.contiguous(), g.seg)
            out.index_put_((g.rows, g.cols), sums.reshape(-1, g.ta, g.tb))
        return out

    def assemble_w(self, vflat) -> torch.Tensor:
        """W = E'F, dense (e_size, f_size)."""
        return self._assemble(self.w_groups, vflat, (self.pm.e_size, self.pm.f_size))

    def assemble_ftf(self, vflat) -> torch.Tensor:
        """F'F, dense (f_size, f_size)."""
        return self._assemble(self.ftf_groups, vflat, (self.pm.f_size, self.pm.f_size))


def apply_minv_rows(pm: pt.PartitionedMeta, factors, W: torch.Tensor) -> torch.Tensor:
    """(E'E + D_e^2)^{-1} W, blockwise over W's e-block rows."""
    outs = []
    for (off, nv, t, _), L in zip(pm.e_fams, factors):
        rows = W[off:off + nv * t].reshape(nv, t, W.shape[1])
        outs.append(torch.cholesky_solve(rows, L).reshape(nv * t, W.shape[1]))
    return torch.cat(outs) if outs else W


def dense_schur_solve(ops: DenseSchurOps, vflat, b: torch.Tensor,
                      D: torch.Tensor) -> torch.Tensor:
    """y minimizing |J y - b|^2 + |D y|^2 for the flattened block values
    `vflat`: eliminate, factor S by Cholesky, back-substitute; in the
    global tangent layout."""
    pm, fl = ops.pm, ops.flat
    D_e = pt.extract_e(pm, D)
    D_f = pt.extract_f(pm, D)
    factors = [cholesky_lower(blk.reshape(nv, t, t) + torch.diag_embed(
        (D_e[off:off + nv * t] ** 2).reshape(nv, t)))
        for (off, nv, t, _), blk in zip(pm.e_fams, fl.block_ete(vflat))]
    W = ops.assemble_w(vflat)
    S = ops.assemble_ftf(vflat) + torch.diag(D_f * D_f) - W.T @ apply_minv_rows(pm, factors, W)
    etb = fl.left_e(vflat, b)
    rhs = fl.left_f(vflat, b) - W.T @ apply_minv_rows(pm, factors, etb[:, None])[:, 0]
    z = torch.cholesky_solve(rhs[:, None], cholesky_lower(S))[:, 0]
    y_e = apply_minv_rows(pm, factors, (etb - W @ z)[:, None])[:, 0]
    return pt.combine(pm, y_e, z)
