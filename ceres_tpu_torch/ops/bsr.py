"""Block-sparse Jacobian structure (counterpart of ceres_tpu/ops/bsr.py).

The structure meta the Schur and CGNR paths plan from: per family its
tangent span, per kind and slot the variable-block id of every row. Arrays
are numpy; the planning they feed runs once per compiled program. The
dense (N, tangent) Jacobian of the DENSE_QR and DENSE_NORMAL_CHOLESKY
steps is scattered from the blocks through an index built once
(`dense_index`, `to_dense`); Problem.evaluate's CRS Jacobian is built
from the blocks on the host without it (`to_crs`).

The solvers' linear-operator ops over the block values (J v, J'u,
diag(J'J), column scaling, the block-Jacobi blocks of J'J and their
inverse) are ops/flatops.FlatJacobianOps's, over its kernels. The plain
forms of the first four (bsr.py:138-208) are here too, with their
`*_args` twins (bsr.py:294-370), which read each slot's tangent columns
from a CompiledProgram.make_args shard (`tangent_idx`, the tangent size
for a constant block or a padding row): the generic multi-device kernels
(parallel/mesh.py) run them over a rank's rows. The scatter-adds go
through program.scatter_add_rows, in the same order on every call.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..program import scatter_add_rows


@dataclasses.dataclass(frozen=True)
class SlotMeta:
    block_ids: np.ndarray  # (B,) int64 global variable-block id
    t: int
    family_index: int


@dataclasses.dataclass(frozen=True)
class KindMeta:
    row_offset: int
    B: int
    r: int
    slots: Tuple[SlotMeta, ...]


@dataclasses.dataclass(frozen=True)
class FamilyMeta:
    """Variable blocks of one family: a contiguous tangent span of num_var
    blocks, each t wide."""

    tangent_offset: int
    num_var: int
    t: int
    block_id_offset: int


@dataclasses.dataclass(frozen=True)
class BlockJacobianMeta:
    kinds: Tuple[KindMeta, ...]
    families: Tuple[FamilyMeta, ...]
    tangent_size: int

    @property
    def num_rows(self) -> int:
        return sum(k.B * k.r for k in self.kinds)


def build_meta(program) -> BlockJacobianMeta:
    """The symbolic phase, done once per compiled program
    (BlockJacobianWriter::BuildJacobianLayout, block_jacobian_writer.cc:68)."""
    families: List[FamilyMeta] = []
    next_block_id = 0
    for fam in program.families:
        families.append(FamilyMeta(fam.tangent_offset, fam.num_var, fam.tsize,
                                   next_block_id))
        next_block_id += fam.num_var
    kinds = []
    for kind in program.kinds:
        slots = []
        for s in kind.slots:
            fm = families[s.family_index]
            pos = s.pos_in_family
            block_ids = np.where(pos < fm.num_var, fm.block_id_offset + pos,
                                 next_block_id).astype(np.int64)
            slots.append(SlotMeta(block_ids, fm.t, s.family_index))
        kinds.append(KindMeta(kind.row_offset, kind.B, kind.r, tuple(slots)))
    return BlockJacobianMeta(tuple(kinds), tuple(families), program.tangent_size)


def dense_index(meta: BlockJacobianMeta, device) -> Tuple[Tuple[torch.Tensor, ...], ...]:
    """Per kind and slot, the place of each entry of its (B, r, t) block in
    the row-major (N, tangent + 1) dense Jacobian: row kind.row_offset +
    b * r + i, column the block's tangent offset + j, or the extra last
    column for a constant block (program.py:654-661)."""
    T = meta.tangent_size
    out = []
    for kind in meta.kinds:
        rows = kind.row_offset + np.arange(kind.B * kind.r, dtype=np.int64).reshape(
            kind.B, kind.r)
        per_slot = []
        for slot in kind.slots:
            cols = _block_columns(meta, slot)
            flat = rows[:, :, None] * (T + 1) + cols[:, None, :]
            per_slot.append(torch.as_tensor(flat.reshape(-1), device=device))
        out.append(tuple(per_slot))
    return tuple(out)


def to_dense(meta: BlockJacobianMeta, block_jacs, index, num_rows: int) -> torch.Tensor:
    """The dense (N, tangent) Jacobian of the blocks [kind][slot] (B, r, t),
    in float64 as the JAX package assembles it (program.py:585-590), the
    entries of a block that appears in two slots of a residual summed."""
    T = meta.tangent_size
    ref = block_jacs[0][0] if block_jacs and block_jacs[0] else None
    device = ref.device if ref is not None else None
    flat = torch.zeros(num_rows * (T + 1), dtype=torch.float64, device=device)
    for jacs, idx in zip(block_jacs, index):
        for J, ix in zip(jacs, idx):
            flat.index_add_(0, ix, J.reshape(-1).to(torch.float64))
    return flat.reshape(num_rows, T + 1)[:, :T]


def _block_columns(meta: BlockJacobianMeta, slot: SlotMeta) -> np.ndarray:
    """(B, t) tangent columns of a slot's blocks, the tangent size for a
    constant block."""
    fm = meta.families[slot.family_index]
    local = slot.block_ids - fm.block_id_offset
    return np.where((local < fm.num_var)[:, None],
                    fm.tangent_offset + local[:, None] * fm.t
                    + np.arange(fm.t, dtype=np.int64), meta.tangent_size)


# --------------------------------------------------------------------------
# Linear-operator ops over the block values [kind][slot] (B, r, t)
# --------------------------------------------------------------------------


def tangent_index(meta: BlockJacobianMeta, device):
    """Per kind and slot, the (B, t) tangent columns of its blocks (the
    tangent size for a constant block), as the args' `tangent_idx`."""
    return [[torch.as_tensor(_block_columns(meta, slot), device=device)
             for slot in kind.slots] for kind in meta.kinds]


def _shapes(meta: BlockJacobianMeta):
    return [(kind.B, kind.r) for kind in meta.kinds]


def _meta_args(meta: BlockJacobianMeta, values):
    """The meta's tangent columns in the args' layout."""
    dev = values[0][0].device
    return [{"tangent_idx": idx} for idx in tangent_index(meta, dev)]


def right_multiply(meta: BlockJacobianMeta, values, v):
    """y = J v (BlockSparseMatrix::RightMultiplyAndAccumulate)."""
    return right_multiply_args(_shapes(meta), _meta_args(meta, values), values, v)


def left_multiply(meta: BlockJacobianMeta, values, u):
    """g = J'u (LeftMultiplyAndAccumulate)."""
    return left_multiply_args(_shapes(meta), _meta_args(meta, values), values, u,
                              meta.tangent_size)


def squared_column_norm(meta: BlockJacobianMeta, values):
    """diag(J'J) (SquaredColumnNorm)."""
    return squared_column_norm_args(_shapes(meta), _meta_args(meta, values), values,
                                    meta.tangent_size)


def scale_columns(meta: BlockJacobianMeta, values, scale):
    """J diag(scale) (ScaleColumns)."""
    return scale_columns_args(_meta_args(meta, values), values, scale)


def right_multiply_args(kind_shapes, args, values, v):
    """y = J v over the args' rows; kind_shapes: (B, r) of each kind's
    (padded) rows. Rows are kind-major."""
    vp = torch.cat([v, v.new_zeros((1,))])  # the sentinel column reads 0
    outs = []
    for k, (B, r) in enumerate(kind_shapes):
        acc = vp.new_zeros((B, r))
        for s, idx in enumerate(args[k]["tangent_idx"]):
            V = values[k][s]
            acc = acc + torch.sum(V * vp[idx][:, None, :].to(V.dtype), dim=2)
        outs.append(acc.reshape(-1))
    return torch.cat(outs) if outs else vp[:0]


def left_multiply_args(kind_shapes, args, values, u, tangent_size):
    """g = J'u over the args' rows."""
    g = u.new_zeros((tangent_size + 1,))
    off = 0
    for k, (B, r) in enumerate(kind_shapes):
        rows = u[off:off + B * r].reshape(B, r)
        off += B * r
        for s, idx in enumerate(args[k]["tangent_idx"]):
            contrib = torch.sum(values[k][s] * rows[:, :, None].to(values[k][s].dtype),
                                dim=1)
            scatter_add_rows(g, idx.reshape(-1), contrib.reshape(-1).to(g.dtype))
    return g[:tangent_size]


def squared_column_norm_args(kind_shapes, args, values, tangent_size):
    out = values[0][0].new_zeros((tangent_size + 1,))
    for k in range(len(kind_shapes)):
        for s, idx in enumerate(args[k]["tangent_idx"]):
            V = values[k][s]
            scatter_add_rows(out, idx.reshape(-1), torch.sum(V * V, dim=1).reshape(-1))
    return out[:tangent_size]


def scale_columns_args(args, values, scale):
    sp = torch.cat([scale, scale.new_zeros((1,))])
    return [[V * sp[args[k]["tangent_idx"][s]][:, None, :].to(V.dtype)
             for s, V in enumerate(slots)] for k, slots in enumerate(values)]


@dataclasses.dataclass
class CRSMatrix:
    """Compressed-row sparse matrix (crs_matrix.h): `rows` the (num_rows +
    1,) row pointers, `cols` and `values` each row's columns, ascending,
    and entries."""

    num_rows: int
    num_cols: int
    rows: np.ndarray
    cols: np.ndarray
    values: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.values.size)

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.num_rows, self.num_cols), self.values.dtype)
        r = np.repeat(np.arange(self.num_rows), np.diff(self.rows.astype(np.int64)))
        out[r, self.cols] = self.values
        return out


def to_crs(meta: BlockJacobianMeta, values) -> CRSMatrix:
    """The tangent-space Jacobian as a CRSMatrix from the block Jacobians
    values[kind][slot] (B, r, t) (numpy), without the dense matrix
    (bsr.py:372-413): COO entries of the variable blocks, sorted by row
    and column, the entries of a block that appears in two slots of a
    residual summed."""
    rows_l, cols_l, vals_l = [], [], []
    for k, kind in enumerate(meta.kinds):
        row_base = kind.row_offset + np.arange(kind.B * kind.r, dtype=np.int64).reshape(
            kind.B, kind.r)
        for s, slot in enumerate(kind.slots):
            v = np.asarray(values[k][s])
            rr = np.broadcast_to(row_base[:, :, None], v.shape)
            cc = np.broadcast_to(_block_columns(meta, slot)[:, None, :], v.shape)
            keep = cc < meta.tangent_size
            rows_l.append(rr[keep])
            cols_l.append(cc[keep])
            vals_l.append(v[keep])
    rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64)
    cols = np.concatenate(cols_l) if cols_l else np.zeros(0, np.int64)
    vals = np.concatenate(vals_l) if vals_l else np.zeros(0, np.float64)
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if rows.size:
        new = np.empty(rows.size, bool)
        new[0] = True
        new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        vals = np.add.reduceat(vals, np.flatnonzero(new))
        rows, cols = rows[new], cols[new]
    rowptr = np.zeros(meta.num_rows + 1, np.int64)
    rowptr[1:] = np.cumsum(np.bincount(rows, minlength=meta.num_rows))
    return CRSMatrix(meta.num_rows, meta.tangent_size, rowptr, cols.astype(np.int32), vals)
