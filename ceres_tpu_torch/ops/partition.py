"""The e/f partition of the block Jacobian, J = [E F] (counterpart of
ceres_tpu/ops/partition.py). E-columns are the eliminated blocks (points),
F-columns the rest (cameras).

The partitioned products E y, F z, E'u, F'u and the diagonal blocks of
E'E and F'F (partition.py:150-250) are ops/flatops.FlatSchurOps's, over
its kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from . import bsr


@dataclasses.dataclass(frozen=True)
class PartitionedMeta:
    base: bsr.BlockJacobianMeta
    e_family_indices: Tuple[int, ...]
    f_family_indices: Tuple[int, ...]
    # families of each partition: (local_t_off, num_var, t, local_bid_off)
    e_fams: Tuple[Tuple[int, int, int, int], ...]
    f_fams: Tuple[Tuple[int, int, int, int], ...]

    @property
    def f_size(self) -> int:
        return sum(nv * t for _, nv, t, _ in self.f_fams)

    @property
    def e_size(self) -> int:
        return sum(nv * t for _, nv, t, _ in self.e_fams)


def build_partition(meta: bsr.BlockJacobianMeta,
                    e_family_indices: Sequence[int]) -> PartitionedMeta:
    e_set = set(int(i) for i in e_family_indices)
    for kind in meta.kinds:
        if sum(1 for s in kind.slots if s.family_index in e_set) > 1:
            raise ValueError(
                "invalid Schur partition: a residual kind touches two e-blocks")
    e_list = [i for i in range(len(meta.families)) if i in e_set]
    f_list = [i for i in range(len(meta.families)) if i not in e_set]

    def local_layout(fam_indices):
        off = bid_off = 0
        fams = []
        for fi in fam_indices:
            f = meta.families[fi]
            fams.append((off, f.num_var, f.t, bid_off))
            off += f.num_var * f.t
            bid_off += f.num_var
        return tuple(fams)

    return PartitionedMeta(meta, tuple(e_list), tuple(f_list),
                           local_layout(e_list), local_layout(f_list))


def _extract(pm, g, fam_indices, fams):
    segs = []
    for fi, (off, nv, t, _) in zip(fam_indices, fams):
        start = pm.base.families[fi].tangent_offset
        segs.append(g[start:start + nv * t])
    return torch.cat(segs) if segs else g.new_zeros((0,))


def extract_e(pm: PartitionedMeta, g: torch.Tensor) -> torch.Tensor:
    """Project a global tangent vector onto the e-partition layout."""
    return _extract(pm, g, pm.e_family_indices, pm.e_fams)


def extract_f(pm: PartitionedMeta, g: torch.Tensor) -> torch.Tensor:
    return _extract(pm, g, pm.f_family_indices, pm.f_fams)


def combine(pm: PartitionedMeta, y_e: torch.Tensor,
            z_f: torch.Tensor) -> torch.Tensor:
    """A global tangent vector from the partition-local vectors."""
    out = (y_e if y_e.numel() else z_f).new_zeros((pm.base.tangent_size,))
    for fi, (off, nv, t, _) in zip(pm.e_family_indices, pm.e_fams):
        start = pm.base.families[fi].tangent_offset
        out[start:start + nv * t] = y_e[off:off + nv * t]
    for fi, (off, nv, t, _) in zip(pm.f_family_indices, pm.f_fams):
        start = pm.base.families[fi].tangent_offset
        out[start:start + nv * t] = z_f[off:off + nv * t]
    return out


def slot_layouts(pm: PartitionedMeta, e: bool):
    """(k, s, partition family index, (B,) local block ids with the
    sentinel nv for a constant block) of every slot in the e or the f
    partition that holds a variable block."""
    fam_indices, fams = ((pm.e_family_indices, pm.e_fams) if e
                         else (pm.f_family_indices, pm.f_fams))
    fam_indices = list(fam_indices)
    for k, kind in enumerate(pm.base.kinds):
        for s, slot in enumerate(kind.slots):
            if slot.family_index not in fam_indices:
                continue
            fi = fam_indices.index(slot.family_index)
            nv = fams[fi][1]
            local = slot.block_ids - pm.base.families[slot.family_index].block_id_offset
            var = (local >= 0) & (local < nv)
            if var.any():
                yield k, s, fi, np.where(var, local, nv)
