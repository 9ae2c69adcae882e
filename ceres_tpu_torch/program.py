"""CompiledProgram: a Problem lowered to static batched tensors
(counterpart of ceres_tpu/program.py).

Layout, as in the JAX package:
 - the state vector x is family-major and block-contiguous in the ambient
   coordinates; a family is one ParameterBlockArray, so gathering a
   family is a reshape;
 - the tangent vector (steps, gradients, the LM diagonal) is family-major
   in each family's tangent coordinates: a family with a manifold has
   `tsize` < `asize` columns there, and `plus` maps a tangent step onto
   the state;
 - residual blocks of one batched add form one *kind*; a kind's rows are
   sorted by its largest family's block ids (for BAL: by point), so
   per-point sums are contiguous segments (the JAX package's
   `sort_rows=True`, which is what its fused path uses).

`_eval_core` is the plain evaluation: the cost function's own residual,
differentiated by torch.func, its Jacobian taken to the tangent space
through each manifold's PlusJacobian and corrected for the kind's robust
loss (`loss.correct_residuals_and_jacobians`); the flat Schur path and
CGNR evaluate through it, and the dense solvers through it with the dense
Jacobian scattered from its blocks (ops/bsr.py). The jt path evaluates
through the eval_fused kernel instead (ops/flatops.py).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .loss import TrivialLoss, correct_residuals_and_jacobians
from .manifolds import EuclideanManifold, Manifold
from .problem import ParameterBlockArray, Problem


@dataclasses.dataclass
class Family:
    """One ParameterBlockArray: `count` blocks of `asize` parameters, with
    `tsize` tangent coordinates each under its manifold."""

    manifold: Optional[Manifold]  # None: Euclidean
    asize: int
    num_var: int
    state_offset: int
    tangent_offset: int
    array: ParameterBlockArray

    @property
    def tsize(self) -> int:
        if self.manifold is None:
            return self.asize
        return self.manifold.tangent_size

    @property
    def euclidean(self) -> bool:
        return self.manifold is None or isinstance(self.manifold, EuclideanManifold)

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
# rows per batched evaluation in _eval_core
EVAL_CHUNK_ROWS = 1 << 20


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
        self._index = {}
        self._dense = None  # (meta, dense index), built on first request
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
            fam = Family(manifold=arr.manifold, asize=arr.size, num_var=arr.B,
                         state_offset=state_off, tangent_offset=tangent_off,
                         array=arr)
            fam_of[id(arr)] = len(self.families)
            self.families.append(fam)
            state_off += arr.B * arr.size
            tangent_off += arr.B * fam.tsize
        self.state_size = state_off
        self.tangent_size = tangent_off

        self.kinds: List[Kind] = []
        row_off = 0
        for rec in records:
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

    def _slot_index(self, k: int, s: int) -> torch.Tensor:
        """The device copy of a slot's block rows, made on first use."""
        key = (k, s)
        if key not in self._index:
            self._index[key] = torch.as_tensor(self.kinds[k].slots[s].pos_in_family,
                                               device=self.device)
        return self._index[key]

    def _plus_jacobians(self, xc: torch.Tensor):
        """{family index: (count, asize, tsize) PlusJacobians} of the
        families with a non-Euclidean manifold, in xc's dtype
        (program.py:519-529)."""
        out = {}
        for i, fam in enumerate(self.families):
            if not fam.euclidean:
                out[i] = torch.func.vmap(fam.manifold.plus_jacobian)(
                    self.family_table(xc, fam))
        return out

    def _eval_core(self, x: torch.Tensor, dense_jac: bool = False):
        """Plain evaluation: {"cost": f64 scalar, "residuals": (N,),
        "block_jacs": [kind][slot] (B, r, t)} in the compute dtype, and with
        `dense_jac` "jacobian", the dense (N, tangent) float64 Jacobian
        (program.py:565, the `dense_jac` branch), with
        tangent-space Jacobians (J_ambient PlusJacobian) and the kind's
        loss applied by the corrector: the cost is 1/2 sum rho(|r|^2), the
        residuals and Jacobians the corrected ones (program.py:620-642).
        Rows are evaluated EVAL_CHUNK_ROWS at a time, which bounds the
        memory of the batched forward-mode Jacobian and changes no value."""
        xc = x.to(self.compute_dtype)
        total = torch.zeros((), dtype=torch.float64, device=x.device)
        plus_jacs = self._plus_jacobians(xc)
        res_chunks, block_jacs = [], []
        for k, kind in enumerate(self.kinds):
            tables = [self.family_table(xc, s.family) for s in kind.slots]
            trivial = kind.loss is None or isinstance(kind.loss, TrivialLoss)
            parts = []
            for a in range(0, kind.B, EVAL_CHUNK_ROWS):
                rows = slice(a, min(a + EVAL_CHUNK_ROWS, kind.B))
                index = [self._slot_index(k, s)[rows] for s in range(len(tables))]
                params = tuple(tab[i] for tab, i in zip(tables, index))
                data = None if kind.data is None else kind.data[rows]
                res, jacs = kind.cost.batched_residuals_and_jacobians(params, data)
                jacs = [J if s.family_index not in plus_jacs else torch.einsum(
                    "bra,bat->brt", J, plus_jacs[s.family_index][i])
                    for s, i, J in zip(kind.slots, index, jacs)]
                cost_b = None
                if not trivial:
                    cost_b, res, jacs = correct_residuals_and_jacobians(
                        kind.loss, res, jacs)
                parts.append((res, jacs, cost_b))
            if len(parts) == 1:
                res, jacs, cost_b = parts[0]
            else:
                res = torch.cat([p[0] for p in parts])
                jacs = [torch.cat([p[1][s] for p in parts]) for s in range(len(tables))]
                cost_b = None if trivial else torch.cat([p[2] for p in parts])
            block_jacs.append(list(jacs))
            if trivial:
                total = total + 0.5 * torch.sum((res * res).to(torch.float64))
            else:
                total = total + torch.sum(cost_b.to(torch.float64))
            res_chunks.append(res.reshape(-1))
        out = {"cost": total + self.fixed_cost,
               "residuals": torch.cat(res_chunks) if res_chunks
               else torch.zeros((0,), dtype=self.compute_dtype, device=x.device),
               "block_jacs": block_jacs}
        if dense_jac:
            out["jacobian"] = self.dense_jacobian(block_jacs)
        return out

    def dense_jacobian(self, block_jacs) -> torch.Tensor:
        """The dense (N, tangent) float64 Jacobian of the blocks
        (bsr.to_dense), through an index built once."""
        from .ops import bsr

        if self._dense is None:
            meta = bsr.build_meta(self)
            self._dense = (meta, bsr.dense_index(meta, self.device))
        meta, index = self._dense
        return bsr.to_dense(meta, block_jacs, index, self.num_residuals)

    # ------------------------------------------------------- step application

    def plus(self, x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
        """x [+] delta: the state x (state_size,) moved by a tangent step
        delta (tangent_size,), through each family's manifold
        (program.py:744-772, without bounds: port slice 6)."""
        if all(f.euclidean for f in self.families):
            return x + delta
        parts = []
        for fam in self.families:
            xf = self.family_table(x, fam)
            n = fam.count * fam.tsize
            df = delta[fam.tangent_offset:fam.tangent_offset + n].reshape(
                fam.count, fam.tsize)
            xf = xf + df if fam.euclidean else torch.func.vmap(fam.manifold.plus)(xf, df)
            parts.append(xf.reshape(-1))
        return torch.cat(parts) if parts else x
