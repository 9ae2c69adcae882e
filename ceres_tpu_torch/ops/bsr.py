"""Block-sparse Jacobian structure (counterpart of ceres_tpu/ops/bsr.py).

The structure meta the Schur path plans from: per family its tangent span,
per kind and slot the variable-block id of every row. Arrays are numpy;
the planning they feed runs once per compiled program.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


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
