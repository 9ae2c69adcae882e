"""Block-sparse Jacobian structure (counterpart of ceres_tpu/ops/bsr.py).

The structure meta the Schur and CGNR paths plan from: per family its
tangent span, per kind and slot the variable-block id of every row. Arrays
are numpy; the planning they feed runs once per compiled program. The
dense (N, tangent) Jacobian of the DENSE_QR and DENSE_NORMAL_CHOLESKY
steps is scattered from the blocks through an index built once
(`dense_index`, `to_dense`).
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
            fm = meta.families[slot.family_index]
            local = slot.block_ids - fm.block_id_offset
            cols = np.where((local < fm.num_var)[:, None],
                            fm.tangent_offset + local[:, None] * fm.t
                            + np.arange(fm.t, dtype=np.int64), T)
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
