"""Block-sparse Jacobian structure (counterpart of ceres_tpu/ops/bsr.py).

The structure meta the Schur and CGNR paths plan from: per family its
tangent span, per kind and slot the variable-block id of every row. Arrays
are numpy; the planning they feed runs once per compiled program. The
dense (N, tangent) Jacobian of the DENSE_QR and DENSE_NORMAL_CHOLESKY
steps is scattered from the blocks through an index built once
(`dense_index`, `to_dense`); Problem.evaluate's CRS Jacobian is built
from the blocks on the host without it (`to_crs`).

The linear-operator ops over the block values (bsr.py:138-293: J v, J'u,
diag(J'J), column scaling, the block-Jacobi blocks of J'J and their
inverse) are ops/flatops.FlatJacobianOps's, over its kernels.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch


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
