"""CompiledProgram: a Problem lowered to static batched tensors
(counterpart of ceres_tpu/program.py).

Layout, as in the JAX package:
 - the state vector x is family-major and block-contiguous; a family is
   one ParameterBlockArray, so gathering a family is a reshape;
 - the tangent vector equals the state (the slice is Euclidean);
 - residual blocks of one batched add form one *kind*; a kind's rows are
   sorted by its largest family's block ids (for BAL: by point), so
   per-point sums are contiguous segments (the JAX package's
   `sort_rows=True`, which is what its fused path uses).

`_eval_core` is the plain evaluation: the cost function's own residual,
differentiated by torch.func. The fused path evaluates through the
eval_fused kernel instead (ops/flatops.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .loss import TrivialLoss
from .problem import ParameterBlockArray, Problem
from .types import not_ported


@dataclasses.dataclass
class Family:
    """One ParameterBlockArray: `count` blocks of `asize` parameters."""

    manifold: None
    asize: int
    num_var: int
    state_offset: int
    tangent_offset: int
    array: ParameterBlockArray

    @property
    def tsize(self) -> int:
        return self.asize

    @property
    def count(self) -> int:
        return self.array.B


@dataclasses.dataclass
class SlotPlan:
    family: Family
    family_index: int
    pos_in_family: np.ndarray  # (B,) int64 block row in the family


@dataclasses.dataclass
class Kind:
    cost: object
    loss: object
    slots: List[SlotPlan]
    data: Optional[torch.Tensor]  # (B, ...) in the compute dtype, or None
    row_offset: int
    B: int
    r: int


_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless asked otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class CompiledProgram:
    """Static evaluation plan of a Problem snapshot on one device: CUDA
    unless the caller passes device="cpu"."""

    def __init__(self, problem: Problem, compute_dtype: str = "float64",
                 device=None):
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
        self.problem = problem
        self.compute_dtype = _DTYPES[compute_dtype]
        self.device = resolve_device(device)
        self.fixed_cost = 0.0
        self._build()

    def _build(self):
        problem = self.problem
        records = problem.batched_residual_blocks()
        used = {}
        for rec in records:
            for arr, _ in rec.slots:
                used.setdefault(id(arr), arr)
        self.families: List[Family] = []
        fam_of = {}
        state_off = tangent_off = 0
        for arr in problem.parameter_block_arrays():
            if id(arr) not in used:
                continue
            fam = Family(manifold=None, asize=arr.size, num_var=arr.B,
                         state_offset=state_off, tangent_offset=tangent_off,
                         array=arr)
            fam_of[id(arr)] = len(self.families)
            self.families.append(fam)
            state_off += arr.B * arr.size
            tangent_off += arr.B * arr.size
        self.state_size = state_off
        self.tangent_size = tangent_off

        self.kinds: List[Kind] = []
        row_off = 0
        for rec in records:
            if rec.loss is not None and not isinstance(rec.loss, TrivialLoss):
                raise not_ported("robust losses", 3)
            slots = [SlotPlan(family=self.families[fam_of[id(arr)]],
                              family_index=fam_of[id(arr)],
                              pos_in_family=idx.astype(np.int64))
                     for arr, idx in rec.slots]
            data = rec.data
            perm = self._sort_perm(slots)
            if perm is not None:
                slots = [dataclasses.replace(s, pos_in_family=s.pos_in_family[perm])
                         for s in slots]
                if data is not None:
                    data = data[perm]
            if data is not None:
                data = torch.as_tensor(np.ascontiguousarray(data),
                                       dtype=self.compute_dtype,
                                       device=self.device)
            r = rec.cost.num_residuals
            self.kinds.append(Kind(cost=rec.cost, loss=rec.loss, slots=slots,
                                   data=data, row_offset=row_off, B=rec.B, r=r))
            row_off += rec.B * r
        self.num_residuals = row_off

    def _sort_perm(self, slots):
        """Rows ordered by the largest variable family's block ids (None
        when already sorted)."""
        if not slots:
            return None
        best = max(slots, key=lambda s: s.family.count)
        pos = best.pos_in_family
        if np.all(pos[1:] >= pos[:-1]):
            return None
        return np.argsort(pos, kind="stable")

    # ---------------------------------------------------------------- state IO

    def initial_state(self) -> torch.Tensor:
        parts = [f.array.values.reshape(-1) for f in self.families]
        if not parts:
            return torch.zeros((0,), dtype=torch.float64, device=self.device)
        return torch.as_tensor(np.concatenate(parts), dtype=torch.float64,
                               device=self.device)

    def write_state(self, x: torch.Tensor) -> None:
        """Write the solver state back into the caller's arrays."""
        xv = x.detach().to("cpu", torch.float64).numpy()
        for fam in self.families:
            n = fam.count * fam.asize
            fam.array.values[...] = xv[fam.state_offset:fam.state_offset + n].reshape(
                fam.count, fam.asize)

    def family_table(self, x: torch.Tensor, fam: Family) -> torch.Tensor:
        """(count, asize) view of one family's state."""
        n = fam.count * fam.asize
        return x[fam.state_offset:fam.state_offset + n].reshape(fam.count, fam.asize)

    # ------------------------------------------------------------- evaluation

    def _eval_core(self, x: torch.Tensor):
        """Plain evaluation: {"cost": f64 scalar, "residuals": (N,),
        "block_jacs": [kind][slot] (B, r, t)} in the compute dtype."""
        xc = x.to(self.compute_dtype)
        total = torch.zeros((), dtype=torch.float64, device=x.device)
        res_chunks, block_jacs = [], []
        for kind in self.kinds:
            params = tuple(
                self.family_table(xc, s.family)[torch.as_tensor(
                    s.pos_in_family, device=x.device)]
                for s in kind.slots)
            res, jacs = kind.cost.batched_residuals_and_jacobians(params, kind.data)
            block_jacs.append(list(jacs))
            total = total + 0.5 * torch.sum((res * res).to(torch.float64))
            res_chunks.append(res.reshape(-1))
        return {"cost": total + self.fixed_cost,
                "residuals": torch.cat(res_chunks) if res_chunks
                else torch.zeros((0,), dtype=self.compute_dtype, device=x.device),
                "block_jacs": block_jacs}
