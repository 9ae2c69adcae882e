"""SPARSE_SCHUR: the Schur complement assembled as a sparse matrix on the
device and factored by the native sparse Cholesky (counterpart of
ceres_tpu/solvers/linear/sparse_schur.py; schur_complement_solver.cc:292).

    S = F'F + D_f^2 - W' (E'E + D_e^2)^{-1} W,   W = E'F

Symbolic, once per program on the host: the pairs of observations of each
e-block (`enumerate_schur_pairs`, the eliminator's chunks) and the CSR
pattern of S with a plan of its values (ops/inner_product.BlockCSRPlan):
per pair of f families, the F'F products of the rows and the corrections
-W_a' M^{-1} W_b of the observation pairs, in the order of their block
pair and e-block (the chunk). Numeric, per step on the device: each row's
W = E'F block and M^{-1} W, the pairs' W rows gathered by
segment_block_expand (kernel 7), each block pair's products summed by
segment_block_sum (kernel 6), a chunk at a time and then over the chunks,
as the eliminator adds each chunk's own Schur complement (its F'F and its
corrections cancel within the chunk, not across 10^5 terms of a shared
intrinsics block), the
sums written to their CSR positions by one static gather (kernel 7), with
D_f^2 on the diagonal; no atomics; in float64 whatever the evaluation
dtype (`solve`). The values travel to the host with the right-hand side, the host factors and solves (the
symbolic analysis kept across steps), and the e-blocks are back-substituted
on the device (implicit_schur.build_schur_system, back_substitute). With
use_explicit_schur_complement the same values stay on the device and CG
runs over them (`CSRMatvec`). `SchurPairs`, the plan of S's block products,
also forms the cluster preconditioners' blocks (preconditioners.py).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ... import native
from ...ops import flatops as fo
from ...ops import kernels as kn
from ...ops import partition as pt
from ...ops.inner_product import BlockCSRPlan, row_pair_members, row_products
from ...types import LinearSolverTerminationType
from .implicit_schur import back_substitute, build_schur_system


def num_e_blocks(pm: pt.PartitionedMeta) -> int:
    return sum(nv for (_, nv, _, _) in pm.e_fams)


def _slots(pm: pt.PartitionedMeta):
    """(the e slot of each kind or None, its rows' e-block ids, num_e_blocks
    for a constant one, the f slots of each kind): the slots of the
    partition's families that hold a variable block, as the JAX function
    picks them."""
    ne = num_e_blocks(pm)
    kinds = range(len(pm.base.kinds))
    e_slot, e_ids, f_slots = dict.fromkeys(kinds), {}, {k: [] for k in kinds}
    for k, s, fi, local in pt.slot_layouts(pm, True):
        _, nv, _, bid_off = pm.e_fams[fi]
        e_slot[k], e_ids[k] = s, np.where(local < nv, bid_off + local, ne)
    for k, s, _, _ in pt.slot_layouts(pm, False):
        f_slots[k].append(s)
    return e_slot, e_ids, f_slots


def enumerate_schur_pairs(pm: pt.PartitionedMeta):
    """The chunks of the eliminator (sparse_schur.py:40-96), in numpy: the
    same-row f-slot pairs of the F'F part and, per e-block, every ordered
    pair of its observations (a row's f slot) for the W' M^{-1} W
    correction. Returns (ftf_pairs [(k, s1, s2)], pair_buckets {(k1, s1,
    k2, s2): (rows a, rows b, e-block ids) int32}, e slot of each kind),
    in the JAX function's order."""
    e_slot, e_ids, f_slots = _slots(pm)
    ftf_pairs = [(k, s1, s2) for k in range(len(pm.base.kinds))
                 for s1 in f_slots[k] for s2 in f_slots[k]]
    ne = num_e_blocks(pm)
    # the observations in the JAX order: kind, then row, then f slot
    ks, ss, bs, ebs = [], [], [], []
    for k in e_ids:
        if not f_slots[k]:
            continue
        eb = e_ids[k]
        rows = np.flatnonzero(eb < ne)
        nf = len(f_slots[k])
        ks.append(np.full(rows.size * nf, k, np.int64))
        ss.append(np.tile(np.asarray(f_slots[k], np.int64), rows.size))
        bs.append(np.repeat(rows, nf))
        ebs.append(np.repeat(eb[rows], nf))
    if not ks:
        return ftf_pairs, {}, e_slot
    k_o, s_o, b_o, eb_o = (np.concatenate(a) for a in (ks, ss, bs, ebs))
    # observations grouped by e-block, the e-blocks in order of first
    # appearance, each one's observations in order
    first = np.full(ne, len(eb_o), np.int64)
    np.minimum.at(first, eb_o, np.arange(len(eb_o)))
    grp = np.argsort(first[eb_o], kind="stable")
    k_o, s_o, b_o, eb_o = k_o[grp], s_o[grp], b_o[grp], eb_o[grp]
    starts = np.flatnonzero(np.concatenate([[True], eb_o[1:] != eb_o[:-1]]))
    sizes = np.diff(np.concatenate([starts, [len(eb_o)]]))
    size_of = np.repeat(sizes, sizes)
    start_of = np.repeat(starts, sizes)
    # every ordered pair (i, j) of one e-block's observations, i major
    a = np.repeat(np.arange(len(eb_o)), size_of)
    first_rep = np.repeat(np.cumsum(size_of) - size_of, size_of)
    b = start_of[a] + (np.arange(a.size) - first_rep)
    # the buckets (k1, s1, k2, s2), in order of first appearance
    n_s = max(len(k.slots) for k in pm.base.kinds)
    n_k = len(pm.base.kinds)
    key = ((k_o[a] * n_s + s_o[a]) * n_k + k_o[b]) * n_s + s_o[b]
    ukeys, first_pos, inv = np.unique(key, return_index=True, return_inverse=True)
    rank = np.argsort(np.argsort(first_pos, kind="stable"), kind="stable")
    order = np.argsort(rank[inv], kind="stable")
    bounds = np.concatenate([[0], np.cumsum(np.bincount(rank[inv], minlength=len(ukeys)))])
    buckets = {}
    for r, u in enumerate(ukeys[np.argsort(rank)]):
        sel = order[bounds[r]:bounds[r + 1]]
        k2, s2 = divmod(int(u) % (n_k * n_s), n_s)
        k1, s1 = divmod(int(u) // (n_k * n_s), n_s)
        buckets[(k1, s1, k2, s2)] = (b_o[a[sel]].astype(np.int32),
                                     b_o[b[sel]].astype(np.int32),
                                     eb_o[a[sel]].astype(np.int32))
    return ftf_pairs, buckets, e_slot


class SchurPairs:
    """The block products of S, planned once on the host and formed on the
    device: per pair of f families, the F'F products of the rows and the
    corrections -W_a' M^{-1} W_b of the observation pairs, each with its
    block pair and chunk (its e-block), as `specs` for the plans of
    ops/inner_product.py. `keep(fa, la, fb, lb)`, a (N,) bool mask over the
    block pairs (partition f family, local block id) of a member, restricts
    the products to the pairs a caller needs (the cluster preconditioners'
    blocks); by default every pair of S is formed."""

    def __init__(self, pm: pt.PartitionedMeta, flat: fo.FlatSchurOps, keep=None):
        self.pm = pm
        self.flat = flat
        dev = flat.device
        meta = pm.base
        self._ftf_pairs, self._pair_buckets, self._e_slot = enumerate_schur_pairs(pm)
        f_fi = {fi: i for i, fi in enumerate(pm.f_family_indices)}

        def local(k, s):
            fam = meta.families[meta.kinds[k].slots[s].family_index]
            return meta.kinds[k].slots[s].block_ids - fam.block_id_offset

        def kept(fa, fb, keys):
            nv_b = pm.f_fams[fb][1]
            if keep is None:
                return np.ones(keys.size, bool)
            return np.asarray(keep(fa, keys // nv_b, fb, keys % nv_b), bool)

        members = {}  # (fa, fb) partition family indices -> [(member, keys)]
        by_fam = {}
        for k, s1, s2 in self._ftf_pairs:
            fa = f_fi[meta.kinds[k].slots[s1].family_index]
            fb = f_fi[meta.kinds[k].slots[s2].family_index]
            by_fam.setdefault((fa, fb), []).append((k, s1, s2))
        # each row's chunk: its e-block, -1 for a row of none
        e_ids = _slots(pm)[1]
        ne = num_e_blocks(pm)
        chunk_of = [np.where(e_ids[k] < ne, e_ids[k], -1) if k in e_ids
                    else np.full(kind.B, -1) for k, kind in enumerate(meta.kinds)]
        for (fa, fb), triples in by_fam.items():
            nv_a, nv_b = pm.f_fams[fa][1], pm.f_fams[fb][1]
            for k, s1, s2 in triples:
                for m, keys in row_pair_members([(k, s1, local(k, s1))],
                                                [(k, s2, local(k, s2))], nv_a, nv_b, dev):
                    rows = np.arange(meta.kinds[k].B) if m[3] is None else m[3].cpu().numpy()
                    sel = kept(fa, fb, keys)
                    if not sel.any():
                        continue
                    if not sel.all():
                        rows, keys = rows[sel], keys[sel]
                        m = m[:3] + (torch.as_tensor(rows, device=dev),)
                    members.setdefault((fa, fb), []).append(
                        (("ftf",) + m, keys, chunk_of[k][rows]))
        # the corrections: each observation's W = E'F block and M^{-1} W are
        # formed once a step (`_rows`); a pair gathers its two rows'
        self._w_slots = sorted({(k, s) for (k1, s1, k2, s2) in self._pair_buckets
                                for k, s in ((k1, s1), (k2, s2))})
        self._w_index = {ks: i for i, ks in enumerate(self._w_slots)}
        for (k1, s1, k2, s2), (ia, ib, eb) in self._pair_buckets.items():
            fa = f_fi[meta.kinds[k1].slots[s1].family_index]
            fb = f_fi[meta.kinds[k2].slots[s2].family_index]
            nv_a, nv_b = pm.f_fams[fa][1], pm.f_fams[fb][1]
            la, lb = local(k1, s1)[ia], local(k2, s2)[ib]
            sel = (la < nv_a) & (lb < nv_b)
            sel[sel] = kept(fa, fb, la[sel] * nv_b + lb[sel])
            if not sel.any():
                continue
            member = ("corr", self._w_index[(k1, s1)], self._w_index[(k2, s2)],
                      torch.as_tensor(ia[sel], device=dev),
                      torch.as_tensor(ib[sel], device=dev))
            members.setdefault((fa, fb), []).append((member, la[sel] * nv_b + lb[sel],
                                                     eb[sel].astype(np.int64)))
        self._e_plan = {k: next(p for p in flat.plans_e[k] if p.s == self._e_slot[k])
                        for k, _ in self._w_slots}
        self.specs = []
        for fa, (off_a, nv_a, ta, _) in enumerate(pm.f_fams):
            for fb, (off_b, nv_b, tb, _) in enumerate(pm.f_fams):
                self.specs.append(((off_a, nv_a, ta), (off_b, nv_b, tb),
                                   members.get((fa, fb), [])))

    def _rows(self, vflat, minv):
        """Per (kind, f slot) of a correction: (W (B, te*tf), M^{-1} W (B,
        te*tf)) of every row, M^{-1} of the row's e-block gathered by
        kernel 7 (zero for a constant e-block)."""
        kinds = self.pm.base.kinds
        out = []
        for k, s in self._w_slots:
            pe = self._e_plan[k]
            B, r = kinds[k].B, kinds[k].r
            tf = kinds[k].slots[s].t
            Je = vflat[k][pe.s].reshape(B, r, pe.t)
            W = fo.small_matmul(Je.transpose(1, 2), vflat[k][s].reshape(B, r, tf))
            M = self.flat._expand(minv[pe.fi], pe).reshape(B, pe.t, pe.t)
            Z = fo.small_matmul(M, W)
            out.append((W.reshape(B, -1).contiguous(), Z.reshape(B, -1).contiguous(), pe.t))
        return out

    def products(self, vflat, minv):
        """products(member, t_a, t_b) of the plans: a row's F'F product, or
        a pair's correction -W_a' M^{-1} W_b from the rows' W and M^{-1} W
        gathered by kernel 7."""
        kinds = self.pm.base.kinds
        rows = self._rows(vflat, minv) if self._w_slots else []

        def products(m, ta, tb):
            if m[0] == "ftf":
                return row_products(kinds, vflat, m[1:], ta, tb)
            _, wa, wb, ia, ib = m
            Wa_all, _, te = rows[wa]
            Zb_all = rows[wb][1]
            Wa = kn.segment_block_expand(Wa_all, ia).reshape(-1, te, ta)
            Zb = kn.segment_block_expand(Zb_all, ib).reshape(-1, te, tb)
            return -fo.small_matmul(Wa.transpose(1, 2), Zb).reshape(-1, ta * tb)

        return products


class CSRMatvec:
    """matvec(values, z): S z for S in CSR with this pattern, the
    use_explicit_schur_complement product (sparse_schur.py:202-217): z
    gathered by column (kernel 7, `cols`), each entry's product summed by
    row in the rows' order (kernel 6 over `rows`, sorted ids), so it
    repeats bit for bit."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray, device):
        n = len(indptr) - 1
        self.rows = fo.build_segment_plan(np.repeat(np.arange(n), np.diff(indptr)), n, device)
        self.cols = torch.as_tensor(np.asarray(indices, np.int32), device=device)

    def __call__(self, values: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        zc = kn.segment_block_expand(z.to(values.dtype)[:, None], self.cols)[:, 0]
        return kn.segment_block_sum((values * zc)[:, None], self.rows)[:, 0]


class SparseSchurSolver:
    """The SPARSE_SCHUR step over a FlatSchurOps (its plans and device);
    with factor=False only S's values and product (the explicit S of
    ITERATIVE_SCHUR), without the host's symbolic factorization."""

    def __init__(self, pm: pt.PartitionedMeta, flat: fo.FlatSchurOps, factor: bool = True):
        self.pm = pm
        self.flat = flat
        self.pairs = SchurPairs(pm, flat)
        self.plan = BlockCSRPlan(pm.f_size, self.pairs.specs, flat.device)
        self.indptr, self.indices, self.nnz = self.plan.indptr, self.plan.indices, self.plan.nnz
        self.chol = (native.SparseCholesky(pm.f_size, self.indptr, self.indices)
                     if factor else None)

    def values(self, vflat, minv, D_f: torch.Tensor) -> torch.Tensor:
        """(nnz,) the CSR values of S, minv the per-e-family inverse
        blocks (E'E + D_e^2)^{-1} (nv, t*t)."""
        return self.plan.values(self.pairs.products(vflat, minv), D_f * D_f)

    def csr_matvec_fn(self) -> CSRMatvec:
        """matvec(values, z) = S z over this solver's CSR pattern."""
        return CSRMatvec(self.indptr, self.indices, self.flat.device)

    def solve(self, vflat, b: torch.Tensor, D: torch.Tensor, to_host: Callable):
        """The SPARSE_SCHUR step of min |J y - b|^2 + |D y|^2: (y in the
        global tangent layout, termination); y is None where the
        factorization fails or z is not finite."""
        pm = self.pm
        # the whole step in float64: S cancels F'F against the corrections
        # down to its small eigenvalues, which float32 sums lose; the JAX
        # function's M^{-1} and corrections are float64 too (its sentinel
        # rows of zeros are), and a right-hand side summed in float32
        # against an S summed in float64 leaves the step a few percent off
        vflat = tuple(tuple(V.to(torch.float64) for V in jacs) for jacs in vflat)
        b, D = b.to(torch.float64), D.to(torch.float64)
        D_e = pt.extract_e(pm, D)
        D_f = pt.extract_f(pm, D)
        sys = build_schur_system(pm, vflat, b, D_e, self.flat)
        svals_t = self.values(vflat, sys.minv, D_f)
        svals, rhs = to_host(svals_t, sys.rhs)
        native.STATS["dtoh_bytes"] += svals_t.nbytes + sys.rhs.nbytes
        if not self.chol.factorize(svals):
            return None, LinearSolverTerminationType.FAILURE
        z = self.chol.solve(rhs)
        if not np.all(np.isfinite(z)):
            return None, LinearSolverTerminationType.FAILURE
        z = torch.as_tensor(z, device=b.device)
        y_e = back_substitute(pm, vflat, sys, z)
        return pt.combine(pm, y_e, z), LinearSolverTerminationType.SUCCESS
