"""Problem: the user-facing modeling graph (counterpart of ceres_tpu/problem.py).

The port carries the batched path: parameter block arrays, each with an
optional manifold, and batched residual blocks with an optional loss,
which is how `models/bal.build_problem_batched` builds a BAL problem.
Parameter blocks are the caller's numpy arrays; `solve` writes the
solution back into them, as `ceres_tpu.solve` does.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .cost_function import CostFunction
from .loss import LossFunction
from .manifolds import Manifold
from .types import not_ported


class ParameterBlockArray:
    """B same-sized parameter blocks stored as one (B, size) float64 array;
    the whole array shares one manifold (None: Euclidean) and is one
    evaluation family."""

    __slots__ = ("values", "B", "size", "manifold")

    def __init__(self, values: np.ndarray, manifold: Optional[Manifold] = None):
        if values.ndim != 2:
            raise ValueError("parameter block array must be 2-D (B, size)")
        if values.dtype != np.float64:
            raise TypeError("parameter blocks must be float64")
        if manifold is not None and manifold.ambient_size != values.shape[1]:
            raise ValueError("manifold ambient size mismatch")
        self.values = values
        self.B = int(values.shape[0])
        self.size = int(values.shape[1])
        self.manifold = manifold


@dataclasses.dataclass
class BatchedResidualBlocks:
    """B residual blocks of one kind: slot i references rows `indices[i]`
    of a ParameterBlockArray; `data` is a (B, ...) array or None."""

    cost: CostFunction
    loss: Optional[LossFunction]
    slots: tuple
    data: object
    rb_id: int
    B: int


class Problem:
    def __init__(self):
        self._block_arrays: List[ParameterBlockArray] = []
        self._batched_residuals = {}
        self._next_rb_id = 0

    def add_parameter_block_array(self, values: np.ndarray,
                                  manifold: Optional[Manifold] = None
                                  ) -> ParameterBlockArray:
        arr = ParameterBlockArray(np.asanyarray(values), manifold)
        self._block_arrays.append(arr)
        return arr

    def set_parameter_block_array_constant(self, arr: ParameterBlockArray):
        raise not_ported("constant parameter block arrays", 6)

    def add_residual_block_batch(self, cost: CostFunction,
                                 loss: Optional[LossFunction], slots,
                                 data=None) -> int:
        sizes = cost.parameter_block_sizes
        if len(slots) != len(sizes):
            raise ValueError("slot count != cost function parameter blocks")
        norm_slots = []
        B = None
        for (arr, idx), expected in zip(slots, sizes):
            if not isinstance(arr, ParameterBlockArray):
                raise TypeError("batched slots must reference ParameterBlockArray")
            if arr.size != expected:
                raise ValueError(
                    f"array block size {arr.size} != cost function size {expected}")
            idx = np.ascontiguousarray(idx, dtype=np.int64)
            if B is None:
                B = idx.shape[0]
            elif idx.shape[0] != B:
                raise ValueError("slot index arrays disagree on batch size")
            if idx.size and (idx.min() < 0 or idx.max() >= arr.B):
                raise ValueError("slot indices out of range")
            norm_slots.append((arr, idx))
        if data is not None:
            data = np.asarray(data)
            if data.shape[0] != B:
                raise ValueError("data leading dimension != batch size")
        rec = BatchedResidualBlocks(cost=cost, loss=loss, slots=tuple(norm_slots),
                                    data=data, rb_id=self._next_rb_id, B=B)
        self._next_rb_id += 1
        self._batched_residuals[rec.rb_id] = rec
        return rec.rb_id

    def batched_residual_blocks(self) -> List[BatchedResidualBlocks]:
        return list(self._batched_residuals.values())

    def parameter_block_arrays(self) -> List[ParameterBlockArray]:
        return list(self._block_arrays)

    def num_parameter_blocks(self) -> int:
        return sum(a.B for a in self._block_arrays)

    def num_parameters(self) -> int:
        return sum(a.B * a.size for a in self._block_arrays)

    def num_residual_blocks(self) -> int:
        return sum(r.B for r in self._batched_residuals.values())

    def num_residuals(self) -> int:
        return sum(r.B * r.cost.num_residuals
                   for r in self._batched_residuals.values())
