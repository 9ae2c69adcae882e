"""Problem: the user-facing modeling graph (counterpart of ceres_tpu/problem.py).

Two ways to add blocks, as in the JAX package: one at a time
(`add_parameter_block`, `add_residual_block`, Ceres style), or batched
(`add_parameter_block_array`, `add_residual_block_batch`), which is how
`models/bal.build_problem_batched` builds a BAL problem with no per-block
Python. Parameter blocks are the caller's float64 numpy arrays, keyed by
the array object; `solve` writes the solution back into them, as
`ceres_tpu.solve` does. Blocks may be held constant and given box bounds
per coordinate (individual blocks) or per array.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cost_function import CostFunction
from .loss import LossFunction
from .manifolds import Manifold
from .utils.tree import tree_leaves, tree_map


class ParameterBlock:
    """One user parameter block (parameter_block.h analog)."""

    __slots__ = ("values", "size", "manifold", "constant", "lower_bounds",
                 "upper_bounds", "residual_blocks", "_owner")

    def __init__(self, values: np.ndarray, manifold: Optional[Manifold] = None):
        if values.ndim != 1:
            raise ValueError("parameter block must be a 1-D array")
        self.values = values
        self.size = int(values.shape[0])
        self.manifold = manifold
        self.constant = False
        self.lower_bounds = None  # allocated on the first bound
        self.upper_bounds = None
        self.residual_blocks: set = set()
        self._owner = None  # the Problem; a bound change bumps its version

    @property
    def tangent_size(self) -> int:
        if self.constant:
            return 0
        return self.manifold.tangent_size if self.manifold else self.size

    def set_lower_bound(self, coord: int, value: float):
        if self.lower_bounds is None:
            self.lower_bounds = np.full(self.size, -np.inf)
        self.lower_bounds[coord] = value
        if self._owner is not None:
            self._owner._bump()

    def set_upper_bound(self, coord: int, value: float):
        if self.upper_bounds is None:
            self.upper_bounds = np.full(self.size, np.inf)
        self.upper_bounds[coord] = value
        if self._owner is not None:
            self._owner._bump()

    def has_bounds(self) -> bool:
        return self.lower_bounds is not None or self.upper_bounds is not None


@dataclasses.dataclass
class ResidualBlock:
    """One residual block: its cost, loss, parameter blocks and data."""

    cost: CostFunction
    loss: Optional[LossFunction]
    blocks: Tuple[ParameterBlock, ...]
    data: object  # a tree of arrays (utils/tree.py), or None
    rb_id: int

    def num_residuals(self) -> int:
        return self.cost.num_residuals


class ParameterBlockArray:
    """B same-sized parameter blocks stored as one (B, size) float64 array;
    the whole array shares one manifold (None: Euclidean) and is one
    evaluation family. It may be held constant and bounded as a whole."""

    __slots__ = ("values", "B", "size", "manifold", "constant", "lower_bounds",
                 "upper_bounds")

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
        self.constant = False
        self.lower_bounds = None  # (B, size) or None
        self.upper_bounds = None


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
        self._ptr_to_block: Dict[int, ParameterBlock] = {}
        self._blocks: List[ParameterBlock] = []
        self._block_arrays: List[ParameterBlockArray] = []
        self._residual_blocks: Dict[int, ResidualBlock] = {}
        self._batched_residuals: Dict[int, BatchedResidualBlocks] = {}
        self._next_rb_id = 0
        self.structure_version = 0  # bumped by every structural change

    def _bump(self):
        self.structure_version += 1

    # -- the batched path ---------------------------------------------------

    def add_parameter_block_array(self, values: np.ndarray,
                                  manifold: Optional[Manifold] = None
                                  ) -> ParameterBlockArray:
        arr = ParameterBlockArray(np.asanyarray(values), manifold)
        self._block_arrays.append(arr)
        self._bump()
        return arr

    def set_parameter_block_array_constant(self, arr: ParameterBlockArray):
        arr.constant = True
        self._bump()

    def set_parameter_block_array_bounds(self, arr: ParameterBlockArray,
                                         lower=None, upper=None):
        """Box bounds for every block of an array (problem.h:333-341 at
        array scale); `lower` and `upper` broadcast to (B, size), a missing
        side is unbounded."""
        shape = (arr.B, arr.size)
        if lower is not None:
            arr.lower_bounds = np.broadcast_to(np.asarray(lower, np.float64), shape).copy()
            if arr.upper_bounds is None:
                arr.upper_bounds = np.full(shape, np.inf)
        if upper is not None:
            arr.upper_bounds = np.broadcast_to(np.asarray(upper, np.float64), shape).copy()
            if arr.lower_bounds is None:
                arr.lower_bounds = np.full(shape, -np.inf)
        self._bump()

    def add_residual_block_batch(self, cost: CostFunction,
                                 loss: Optional[LossFunction], slots,
                                 data=None) -> int:
        """Add B residual blocks of one kind at once: `slots[i]` is
        (ParameterBlockArray, indices (B,)), `data` a (B, ...) array."""
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
        self._bump()
        return rec.rb_id

    def remove_residual_block_batch(self, rb_id: int):
        del self._batched_residuals[rb_id]
        self._bump()

    def batched_residual_blocks(self) -> List[BatchedResidualBlocks]:
        return list(self._batched_residuals.values())

    def parameter_block_arrays(self) -> List[ParameterBlockArray]:
        return list(self._block_arrays)

    # -- parameter blocks (problem.h:258-341) --------------------------------

    def add_parameter_block(self, values: np.ndarray, size: Optional[int] = None,
                            manifold: Optional[Manifold] = None) -> ParameterBlock:
        """`values` is the caller's float64 array: the solution is written
        back into it. Adding the same array again returns its block."""
        values = np.asanyarray(values)
        if values.dtype != np.float64:
            raise TypeError("parameter blocks must be float64 numpy arrays")
        existing = self._ptr_to_block.get(id(values))
        if existing is not None:
            if size is not None and existing.size != size:
                raise ValueError("duplicate parameter block with different size")
            if manifold is not None:
                self.set_manifold(values, manifold)
            return existing
        if size is not None and size != values.shape[0]:
            raise ValueError(f"size {size} != array length {values.shape[0]}")
        if manifold is not None and manifold.ambient_size != values.shape[0]:
            raise ValueError("manifold ambient size mismatch")
        blk = ParameterBlock(values, manifold)
        blk._owner = self
        self._ptr_to_block[id(values)] = blk
        self._blocks.append(blk)
        self._bump()
        return blk

    def _resolve(self, values) -> ParameterBlock:
        if isinstance(values, ParameterBlock):
            return values
        blk = self._ptr_to_block.get(id(values))
        if blk is None:
            raise KeyError("unknown parameter block; pass the same array object")
        return blk

    def remove_parameter_block(self, values):
        """Also removes the residual blocks that depend on it
        (problem_impl.cc:436)."""
        blk = self._resolve(values)
        for rb_id in list(blk.residual_blocks):
            self.remove_residual_block(rb_id)
        del self._ptr_to_block[id(blk.values)]
        self._blocks.remove(blk)
        self._bump()

    def set_parameter_block_constant(self, values):
        blk = self._resolve(values)
        if not blk.constant:
            blk.constant = True
            self._bump()

    def set_parameter_block_variable(self, values):
        blk = self._resolve(values)
        if blk.constant:
            blk.constant = False
            self._bump()

    def is_parameter_block_constant(self, values) -> bool:
        return self._resolve(values).constant

    def set_manifold(self, values, manifold: Optional[Manifold]):
        blk = self._resolve(values)
        if manifold is not None and manifold.ambient_size != blk.size:
            raise ValueError("manifold ambient size mismatch")
        blk.manifold = manifold
        self._bump()

    def get_manifold(self, values) -> Optional[Manifold]:
        return self._resolve(values).manifold

    def set_parameter_lower_bound(self, values, coord: int, bound: float):
        self._resolve(values).set_lower_bound(coord, bound)
        self._bump()

    def set_parameter_upper_bound(self, values, coord: int, bound: float):
        self._resolve(values).set_upper_bound(coord, bound)
        self._bump()

    def get_parameter_lower_bound(self, values, coord: int) -> float:
        blk = self._resolve(values)
        return float(blk.lower_bounds[coord]) if blk.lower_bounds is not None else -np.inf

    def get_parameter_upper_bound(self, values, coord: int) -> float:
        blk = self._resolve(values)
        return float(blk.upper_bounds[coord]) if blk.upper_bounds is not None else np.inf

    # -- residual blocks (problem.h:230) ------------------------------------

    def add_residual_block(self, cost: CostFunction, loss: Optional[LossFunction],
                           parameter_blocks: Sequence, data=None) -> int:
        """Returns the block's id for remove_residual_block. Parameter
        arrays not yet added are added implicitly."""
        sizes = cost.parameter_block_sizes
        if len(parameter_blocks) != len(sizes):
            raise ValueError(f"cost function expects {len(sizes)} parameter blocks, "
                             f"got {len(parameter_blocks)}")
        blocks = []
        for values, expected in zip(parameter_blocks, sizes):
            if isinstance(values, ParameterBlock):
                blk = values
            else:
                blk = self._ptr_to_block.get(id(values)) or self.add_parameter_block(values)
            if blk.size != expected:
                raise ValueError(
                    f"parameter block size {blk.size} != cost function size {expected}")
            blocks.append(blk)
        if len({id(b) for b in blocks}) != len(blocks):
            raise ValueError("duplicate parameter blocks in a single residual block")
        rb = ResidualBlock(cost, loss, tuple(blocks), data, self._next_rb_id)
        self._next_rb_id += 1
        self._residual_blocks[rb.rb_id] = rb
        for b in blocks:
            b.residual_blocks.add(rb.rb_id)
        self._bump()
        return rb.rb_id

    def add_residual_blocks(self, cost: CostFunction, loss: Optional[LossFunction],
                            parameter_blocks: Sequence[Sequence], data=None) -> List[int]:
        """N blocks of one cost in one call: `parameter_blocks[i]` are the
        blocks of the i-th, `data` (if given) a tree whose leaves have a
        leading dimension N."""
        return [self.add_residual_block(
            cost, loss, pbs, None if data is None
            else tree_map(lambda a, i=i: np.asarray(a)[i], data))
            for i, pbs in enumerate(parameter_blocks)]

    def remove_residual_block(self, rb_id: int):
        rb = self._residual_blocks.pop(rb_id)
        for b in rb.blocks:
            b.residual_blocks.discard(rb_id)
        self._bump()

    # -- introspection ------------------------------------------------------

    def num_parameter_blocks(self) -> int:
        return len(self._blocks) + sum(a.B for a in self._block_arrays)

    def num_parameters(self) -> int:
        return (sum(b.size for b in self._blocks)
                + sum(a.B * a.size for a in self._block_arrays))

    def num_residual_blocks(self) -> int:
        return (len(self._residual_blocks)
                + sum(r.B for r in self._batched_residuals.values()))

    def num_residuals(self) -> int:
        return (sum(rb.num_residuals() for rb in self._residual_blocks.values())
                + sum(r.B * r.cost.num_residuals
                      for r in self._batched_residuals.values()))

    def parameter_blocks(self) -> List[ParameterBlock]:
        return list(self._blocks)

    def residual_blocks(self) -> List[ResidualBlock]:
        return list(self._residual_blocks.values())

    def parameter_block_for(self, values) -> ParameterBlock:
        return self._resolve(values)

    # -- evaluation (problem.h:477, :514) -----------------------------------

    def evaluate(self, apply_loss_function: bool = True, residuals: bool = False,
                 gradient: bool = False, jacobian: bool = False,
                 jacobian_format: str = "dense", device=None):
        """The whole problem at the current parameter values, in the
        residual blocks' add order: (cost, residuals?, gradient?, jacobian?),
        a bare cost when nothing else is asked. Gradient and Jacobian are in
        the tangent space of the variable blocks, in the compiled program's
        layout. `jacobian_format="crs"` returns an ops.bsr.CRSMatrix built
        from the block Jacobians without forming the dense matrix. Runs on
        the card unless device="cpu"."""
        from .program import CompiledProgram

        if jacobian_format not in ("dense", "crs"):
            raise ValueError(f"unknown jacobian_format {jacobian_format!r}")
        prog = CompiledProgram(self, apply_loss=apply_loss_function,
                               sort_rows=False, device=device)
        x = prog.initial_state()
        out_res = out_grad = out_jac = None
        if jacobian and jacobian_format == "crs":
            from .ops import bsr

            c, r, g, bjacs = prog.evaluate_bsr(x)
            out_jac = bsr.to_crs(bsr.build_meta(prog),
                                 [[J.detach().cpu().numpy() for J in kind]
                                  for kind in bjacs])
        elif gradient or jacobian:
            c, r, g, J = prog.evaluate_dense(x)
            out_jac = J.cpu().numpy()
        elif residuals:
            c, r = prog.evaluate_residuals(x)
            g = None
        else:
            c, r, g = prog.evaluate_cost(x), None, None
        out_cost = float(c)
        if r is not None:
            out_res = r.detach().to("cpu", dtype=r.dtype).numpy()
        if g is not None:
            out_grad = g.cpu().numpy()
        result = [out_cost]
        if residuals:
            result.append(out_res)
        if gradient:
            result.append(out_grad)
        if jacobian:
            result.append(out_jac)
        return result[0] if len(result) == 1 else tuple(result)

    def evaluate_residual_block(self, rb_id: int, apply_loss_function: bool = True,
                                device=None):
        """One block at the current values: (cost, residuals, [J_i]) as
        numpy arrays, in float64. Runs on the card unless device="cpu"."""
        import torch

        from .loss import correct_residuals_and_jacobians
        from .program import resolve_device

        dev = resolve_device(device)
        rb = self._residual_blocks[rb_id]
        params = [torch.as_tensor(b.values, device=dev) for b in rb.blocks]
        data = tree_map(lambda a: torch.as_tensor(np.asarray(a), device=dev), rb.data)
        res, jacs = rb.cost.residuals_and_jacobians(params, data)
        loss = rb.loss if apply_loss_function else None
        cost_b, res_b, jacs_b = correct_residuals_and_jacobians(
            loss, res[None, :], [J[None] for J in jacs])
        return (float(cost_b[0]), res_b[0].cpu().numpy(),
                [J[0].cpu().numpy() for J in jacs_b])


def data_signature(data):
    """What groups residual blocks' data into one kind: each leaf's shape
    and dtype (program.py:282-290)."""
    if data is None:
        return None
    return tuple((np.shape(leaf), np.asarray(leaf).dtype.str)
                 for leaf in tree_leaves(data))
