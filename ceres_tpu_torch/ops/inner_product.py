"""The inner product J'J as a CSR matrix, its structure planned once and
its values formed on the device (counterpart of
ceres_tpu/ops/inner_product.py; inner_product_computer.h:59).

The JAX class forms every row's block products and scatter-adds them into
the CSR values. Here no sum runs by atomics, so a float64 step repeats bit
for bit: the plan (`BlockCSRPlan`, built once per program) groups the
products by the pair of families their blocks belong to, holds each
group's rows in the order of their block pair, and sums each pair's
products by segment_block_sum (kernel 6) over a SegmentPlan; one static
gather (segment_block_expand, kernel 7) then writes every entry of the
summed blocks to its CSR position, each position taking exactly one
entry, and D^2 is added on the diagonal. The same plan assembles the
sparse Schur complement (solvers/linear/sparse_schur.py), whose groups
hold both its F'F rows and its observation-pair corrections; its base,
`PairSumPlan`, the pair sums without the CSR layout, assembles the cluster
preconditioners' blocks (solvers/linear/preconditioners.py).

The CSR pattern is the JAX class's: every (row, column) some variable
block pair of a row touches, the full symmetric matrix, rows and columns
ascending. A row's block of a constant parameter block takes no part.
`kind_mask` restricts the product to some kinds (subset_preconditioner.h:70).
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import bsr
from . import flatops as fo
from . import kernels as kn


class PairGroup(NamedTuple):
    """The products between the blocks of one family a (block rows) and
    one family b (block columns)."""

    members: tuple  # what each member's products are made from (its caller's)
    ta: int
    tb: int
    order: torch.Tensor  # (N,) int64: the members' products, concatenated, by block pair
    chunk: Optional[fo.SegmentPlan]  # the (pair, chunk) ids of `order`'s products, or None
    seg: fo.SegmentPlan  # the sorted pair ids of the chunk sums (or of the products)
    pairs: np.ndarray  # (U,) int64 la * nv_b + lb of each pair


class PairSumPlan:
    """Sums of t_a x t_b block products, one per block pair, planned once.
    `specs`: per group ((off_a, nv_a, t_a), (off_b, nv_b, t_b), [(member,
    keys[, chunks])]), keys (N_m,) int64 the block pair la * nv_b + lb of
    each of the member's products, in the order they are formed, and
    chunks (N_m,) int64 the chunk of each, or -1 for none. A pair's
    products of one chunk are summed first, then the pair's chunk sums
    (the eliminator's order, chunk by chunk: a chunk's own Schur
    complement sums its F'F against its corrections before the chunks'
    are added up, which keeps the cancellation local). `sums` returns the
    pairs' blocks flattened and concatenated, group by group; entry i of
    it is (rows[i], cols[i]) of the n x n matrix the blocks tile, and no
    two entries share a (row, column)."""

    def __init__(self, specs, device):
        self.device = device
        self.groups: List[PairGroup] = []
        rows_l, cols_l = [], []
        for (off_a, nv_a, ta), (off_b, nv_b, tb), members in specs:
            if not members:
                continue
            keys = np.concatenate([m[1] for m in members]).astype(np.int64)
            chunks = np.concatenate([m[2] if len(m) > 2 else np.full(len(m[1]), -1)
                                     for m in members]).astype(np.int64)
            # a product of no chunk is a chunk of its own
            chunks = np.where(chunks < 0, -1 - np.arange(keys.size), chunks)
            order = np.lexsort((np.arange(keys.size), chunks, keys))
            k_sorted, c_sorted = keys[order], chunks[order]
            pairs = np.unique(k_sorted)
            new = np.ones(keys.size, bool)
            new[1:] = (k_sorted[1:] != k_sorted[:-1]) | (c_sorted[1:] != c_sorted[:-1])
            chunk = None
            if not new.all():
                chunk_ids = np.cumsum(new) - 1
                chunk = fo.build_segment_plan(chunk_ids, int(chunk_ids[-1]) + 1, device)
                k_sorted = k_sorted[new]
            self.groups.append(PairGroup(
                tuple(m[0] for m in members), ta, tb, torch.as_tensor(order, device=device),
                chunk, fo.build_segment_plan(np.searchsorted(pairs, k_sorted), len(pairs),
                                             device), pairs))
            r = off_a + (pairs // nv_b)[:, None, None] * ta + np.arange(ta)[None, :, None]
            c = off_b + (pairs % nv_b)[:, None, None] * tb + np.arange(tb)[None, None, :]
            rows_l.append(np.broadcast_to(r, (len(pairs), ta, tb)).reshape(-1))
            cols_l.append(np.broadcast_to(c, (len(pairs), ta, tb)).reshape(-1))
        self.rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64)
        self.cols = np.concatenate(cols_l) if cols_l else np.zeros(0, np.int64)

    def sums(self, products: Callable) -> torch.Tensor:
        """(entries,) each pair's products summed by kernel 6 (chunk by
        chunk first, where the plan has chunks), flattened and concatenated.
        `products(member, t_a, t_b)` forms a member's (N_m, t_a * t_b)
        products."""
        return torch.cat([self.group_sums(g, products).reshape(-1) for g in self.groups])

    @staticmethod
    def group_products(g: PairGroup, products: Callable) -> torch.Tensor:
        """(N, t_a * t_b) a group's products in the order of their block
        pair and chunk: the rows its first segment sum takes."""
        return torch.cat([products(m, g.ta, g.tb) for m in g.members])[g.order].contiguous()

    @classmethod
    def group_sums(cls, g: PairGroup, products: Callable) -> torch.Tensor:
        """(U, t_a * t_b) each pair's block: kernel 6 over its chunks'
        products, then over the chunk sums."""
        out = cls.group_products(g, products)
        if g.chunk is not None:
            out = kn.segment_block_sum(out, g.chunk)
        return kn.segment_block_sum(out, g.seg)


class BlockCSRPlan(PairSumPlan):
    """A symmetric n x n CSR matrix whose entries are the pair sums of a
    PairSumPlan: every (row, column) of the matrix is one entry of one
    pair's block."""

    def __init__(self, n: int, specs, device):
        super().__init__(specs, device)
        self.n = n
        key = self.rows * n + self.cols
        src = np.argsort(key, kind="stable")
        key = key[src]
        if key.size and np.any(key[1:] == key[:-1]):
            raise ValueError("two block pairs share an entry")
        self.nnz = int(key.size)
        self.indices = (key % n).astype(np.int32)
        self.indptr = np.concatenate(
            [[0], np.cumsum(np.bincount(key // n, minlength=n))]).astype(np.int64)
        diag = np.searchsorted(key, np.arange(n, dtype=np.int64) * (n + 1))
        if n and (np.any(diag >= key.size) or np.any(key[np.minimum(diag, key.size - 1)]
                                                     != np.arange(n) * (n + 1))):
            raise ValueError("a variable block that no residual reads: its diagonal "
                             "entry is missing")
        # each CSR position's entry in the concatenated, flattened pair sums
        self.src = torch.as_tensor(src.astype(np.int32), device=device)
        self.diag = torch.as_tensor(diag, device=device)

    def values(self, products: Callable, D2: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(nnz,) the CSR values: the pair sums written to their positions
        by kernel 7, plus D2 on the diagonal."""
        vals = kn.segment_block_expand(self.sums(products)[:, None], self.src)[:, 0]
        if D2 is not None:
            vals = vals.index_put((self.diag,), vals[self.diag] + D2.to(vals.dtype))
        return vals


def slot_blocks(meta: bsr.BlockJacobianMeta, kind_mask=None):
    """Per family: [(k, s, (B,) local block ids, nv or more for a constant
    block)] of every slot of it that holds a variable block, in kind and
    slot order, the kinds `kind_mask` keeps."""
    out = {}
    for k, kind in enumerate(meta.kinds):
        if kind_mask is not None and not kind_mask[k]:
            continue
        for s, slot in enumerate(kind.slots):
            fam = meta.families[slot.family_index]
            local = slot.block_ids - fam.block_id_offset
            if np.any(local < fam.num_var):
                out.setdefault(slot.family_index, []).append((k, s, local))
    return out


def row_pair_members(slots_a, slots_b, nv_a: int, nv_b: int, device):
    """[(member (k, s_a, s_b, rows or None for all), keys)] of the rows of
    each kind with a variable block in a slot of family a and one in a slot
    of family b."""
    out = []
    for k, sa, la in slots_a:
        for k2, sb, lb in slots_b:
            keep = (la < nv_a) & (lb < nv_b)
            if k2 != k or not keep.any():
                continue
            idx = np.flatnonzero(keep)
            out.append(((k, sa, sb, None if keep.all() else torch.as_tensor(idx, device=device)),
                        la[idx] * nv_b + lb[idx]))
    return out


def row_products(kinds, vflat, member, ta: int, tb: int) -> torch.Tensor:
    """(N, ta * tb): J_a'J_b of each row of a row_pair_members member."""
    k, sa, sb, idx = member
    B, r = kinds[k].B, kinds[k].r
    Ja = vflat[k][sa].reshape(B, r, ta)
    Jb = vflat[k][sb].reshape(B, r, tb)
    if idx is not None:
        Ja, Jb = Ja[idx], Jb[idx]
    return fo.small_matmul(Ja.transpose(1, 2), Jb).reshape(Ja.shape[0], ta * tb)


class InnerProductComputer:
    """J'J (+ D^2) of the block Jacobian in CSR: `indptr`, `indices`
    (the pattern, planned once) and `compute(vflat, D)` (the values)."""

    def __init__(self, meta: bsr.BlockJacobianMeta, device,
                 kind_mask: Optional[Sequence[bool]] = None):
        self.meta = meta
        self.n = meta.tangent_size
        slots = slot_blocks(meta, kind_mask)
        fams = meta.families
        specs = []
        for a in sorted(slots):
            for b in sorted(slots):
                fa, fb = fams[a], fams[b]
                specs.append(((fa.tangent_offset, fa.num_var, fa.t),
                              (fb.tangent_offset, fb.num_var, fb.t),
                              row_pair_members(slots[a], slots[b], fa.num_var, fb.num_var,
                                               device)))
        self.plan = BlockCSRPlan(self.n, specs, device)
        self.indptr, self.indices, self.nnz = self.plan.indptr, self.plan.indices, self.plan.nnz

    def compute(self, vflat, D: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(nnz,) values of J'J + diag(D)^2, vflat the flattened blocks
        [kind][slot] (B, r*t), in their dtype."""
        kinds = self.meta.kinds
        return self.plan.values(lambda m, ta, tb: row_products(kinds, vflat, m, ta, tb),
                                None if D is None else D * D)
