"""CompiledProgram: a Problem lowered to static batched tensors
(counterpart of ceres_tpu/program.py).

Layout, as in the JAX package:
 - the state vector x is family-major and block-contiguous in the ambient
   coordinates. A family is a group of individual blocks of one size and
   manifold (`program.py:_family_key`), or one ParameterBlockArray; the
   individual-block families come first. Gathering a family is a reshape;
 - within a family the variable blocks come first, then the constant ones
   (`num_var` < `count`); a constant array is a family of num_var = 0;
 - the tangent vector (steps, gradients, the LM diagonal) is family-major
   over the variable blocks only, in each family's tangent coordinates: a
   family with a manifold has `tsize` < `asize` columns there, and `plus`
   maps a tangent step onto the state, clipped to the family's box bounds
   where it has them (the constant blocks stay where they are);
 - a residual block whose parameters are all constant is not evaluated:
   its cost is `fixed_cost` (the reduced program, program.cc:291);
 - residual blocks of one batched add, or individual blocks of one cost,
   loss, slot families and data shape, form one *kind*; with `sort_rows`
   (what the solver uses) a kind's rows are sorted by its largest variable
   family's block ids (for BAL: by point), so per-point sums are
   contiguous segments. Problem.evaluate keeps the add order.

`_eval_core` is the plain evaluation: the cost function's own residual
and Jacobian, taken to the tangent space through each manifold's
PlusJacobian and corrected for the kind's robust loss
(`loss.correct_residuals_and_jacobians`); the flat Schur path, CGNR and the
bounded line search's cost probes evaluate through it, the dense solvers
through it with the dense Jacobian scattered from its blocks (ops/bsr.py).
The jt path evaluates through the eval_fused kernel instead
(ops/flatops.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from .loss import TrivialLoss, correct_residuals_and_jacobians
from .manifolds import EuclideanManifold, Manifold
from .problem import ParameterBlock, ParameterBlockArray, Problem, data_signature
from .utils.tree import tree_map, tree_stack


@dataclasses.dataclass
class Family:
    """`count` blocks of `asize` parameters, with `tsize` tangent
    coordinates each under its manifold: individual blocks (`blocks`) or
    one ParameterBlockArray (`array`). The first num_var are variable;
    `lower`/`upper` (num_var, asize) are their box, or None."""

    manifold: Optional[Manifold]  # None: Euclidean
    asize: int
    num_var: int
    state_offset: int
    tangent_offset: int
    array: Optional[ParameterBlockArray] = None
    blocks: List[ParameterBlock] = dataclasses.field(default_factory=list)
    lower: Optional[np.ndarray] = None
    upper: Optional[np.ndarray] = None

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
        return self.array.B if self.array is not None else len(self.blocks)


@dataclasses.dataclass
class SlotPlan:
    family: Family
    family_index: int
    pos_in_family: np.ndarray  # (B,) int64 block row in the family
    any_variable: bool = True


@dataclasses.dataclass
class Kind:
    cost: object
    loss: object
    slots: List[SlotPlan]
    data: object  # a tree of (B, ...) tensors, floats in the compute dtype, or None
    row_offset: int
    B: int
    r: int
    # (B,) the residual block id of each row (Problem.add_residual_block's),
    # None for a batch of residual blocks (one id for all its rows)
    rb_ids: Optional[np.ndarray] = None


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


def scatter_add_rows(out: torch.Tensor, index: torch.Tensor, rows: torch.Tensor):
    """out[index[i]] += rows[i], in place, in the same order on every call:
    on a card `index_put_` with accumulate sorts by index where
    `index_add_` adds by atomics, whose order changes from run to run."""
    return out.index_put_((index,), rows, accumulate=True)


def _family_key(blk: ParameterBlock):
    mkey = blk.manifold.batch_key() if blk.manifold is not None else ("Euclidean", blk.size)
    return (blk.size, mkey)


def _sort_perm(slots: List[SlotPlan]):
    """Rows ordered by the largest variable family's block ids (None when
    already sorted or no slot is variable)."""
    best = max((s for s in slots if s.any_variable), key=lambda s: s.family.count,
               default=None)
    if best is None:
        return None
    pos = best.pos_in_family
    if np.all(pos[1:] >= pos[:-1]):
        return None
    return np.argsort(pos, kind="stable")


class CompiledProgram:
    """Static evaluation plan of a Problem snapshot on one device: CUDA
    unless the caller passes device="cpu"."""

    def __init__(self, problem: Problem, compute_dtype: str = "float64",
                 device=None, apply_loss: bool = True, sort_rows: bool = True):
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}")
        self.problem = problem
        # the callbacks check it against the problem's (callbacks.py)
        self.structure_version = problem.structure_version
        self.compute_dtype = _DTYPES[compute_dtype]
        self.device = resolve_device(device)
        self.apply_loss = apply_loss
        self.sort_rows = sort_rows
        self._index = {}
        self._dense = None  # (meta, dense index), built on first request
        self._grad_index = None
        self._box = None  # the bounds on the device, built on first request
        # the fused minimizers built over this program, by tier, e-families
        # and options (solver._maybe_build_fused, the fused line search)
        self._minimizer_cache: Dict[object, object] = {}
        self._build()

    @classmethod
    def cached(cls, problem: Problem, apply_loss: bool = True,
               compute_dtype: str = "float64", sort_rows: bool = False, device=None):
        """The program of an unchanged Problem, reused across solves
        (program.py:138-158): with it its device plans and its cached fused
        minimizers. The key is the JAX one plus the device, so a program
        built for a card never serves a CPU solve. Every structural
        mutation bumps Problem.structure_version and makes a new program.
        Parameter values are read live (initial_state); the cost of the
        residual blocks whose parameters are all constant, the one value
        a program computes at build, is computed anew on reuse."""
        dev = resolve_device(device)
        key = (bool(apply_loss), str(compute_dtype), bool(sort_rows), str(dev))
        cache = problem._compiled_cache
        prog = cache.get(key)
        if prog is not None and prog.structure_version == problem.structure_version:
            if prog._fixed_rbs or prog.batched_fixed:
                prog.fixed_cost = prog._fixed_cost(prog._fixed_rbs)
            return prog
        prog = cls(problem, compute_dtype, device=dev, apply_loss=apply_loss,
                   sort_rows=sort_rows)
        cache[key] = prog
        return prog

    # ------------------------------------------------------------------ build

    def _data_tensor(self, data):
        """A stacked data tree on the device, floats in the compute dtype."""
        def leaf(a):
            a = np.ascontiguousarray(a)
            dt = self.compute_dtype if np.issubdtype(a.dtype, np.floating) else None
            return torch.as_tensor(a, dtype=dt, device=self.device)

        return tree_map(leaf, data)

    def _build(self):
        problem = self.problem
        # the reduced program: residual blocks with a variable parameter
        active, fixed = [], []
        for rb in problem.residual_blocks():
            (active if any(not b.constant for b in rb.blocks) else fixed).append(rb)
        used = {id(b) for rb in active for b in rb.blocks}

        self.families: List[Family] = []
        fam_of_key: Dict[tuple, Family] = {}
        for b in problem.parameter_blocks():
            if id(b) not in used:
                continue
            key = _family_key(b)
            if key not in fam_of_key:
                fam_of_key[key] = Family(manifold=b.manifold, asize=b.size, num_var=0,
                                         state_offset=0, tangent_offset=0)
                self.families.append(fam_of_key[key])
            fam_of_key[key].blocks.append(b)
        state_off = tangent_off = 0
        self._block_pos = {}  # id(block) -> (family index, position)
        for fi, fam in enumerate(self.families):
            variable = [b for b in fam.blocks if not b.constant]
            fam.blocks = variable + [b for b in fam.blocks if b.constant]
            fam.num_var = len(variable)
            fam.state_offset, fam.tangent_offset = state_off, tangent_off
            state_off += fam.count * fam.asize
            tangent_off += fam.num_var * fam.tsize
            for i, b in enumerate(fam.blocks):
                self._block_pos[id(b)] = (fi, i)
            if any(b.has_bounds() for b in variable):
                fam.lower = np.full((fam.num_var, fam.asize), -np.inf)
                fam.upper = np.full((fam.num_var, fam.asize), np.inf)
                for i, b in enumerate(variable):
                    if b.lower_bounds is not None:
                        fam.lower[i] = b.lower_bounds
                    if b.upper_bounds is not None:
                        fam.upper[i] = b.upper_bounds

        records = problem.batched_residual_blocks()
        used_arrays = {id(arr) for rec in records for arr, _ in rec.slots}
        fam_of_array = {}
        for arr in problem.parameter_block_arrays():
            if id(arr) not in used_arrays:
                continue
            fam = Family(manifold=arr.manifold, asize=arr.size,
                         num_var=0 if arr.constant else arr.B,
                         state_offset=state_off, tangent_offset=tangent_off, array=arr)
            if not arr.constant and (arr.lower_bounds is not None
                                     or arr.upper_bounds is not None):
                shape = (arr.B, arr.size)
                fam.lower = (arr.lower_bounds if arr.lower_bounds is not None
                             else np.full(shape, -np.inf))
                fam.upper = (arr.upper_bounds if arr.upper_bounds is not None
                             else np.full(shape, np.inf))
            fam_of_array[id(arr)] = len(self.families)
            self.families.append(fam)
            state_off += arr.B * arr.size
            tangent_off += fam.num_var * fam.tsize
        self.state_size = state_off
        self.tangent_size = tangent_off

        self.kinds: List[Kind] = []
        self._row_off = 0

        def add_kind(cost, loss, slots, data, B, rb_ids=None):
            perm = _sort_perm(slots) if self.sort_rows else None
            if perm is not None:
                slots = [dataclasses.replace(s, pos_in_family=s.pos_in_family[perm])
                         for s in slots]
                if data is not None:
                    data = tree_map(lambda a: np.asarray(a)[perm], data)
                if rb_ids is not None:
                    rb_ids = rb_ids[perm]
            r = cost.num_residuals
            self.kinds.append(Kind(cost=cost, loss=loss if self.apply_loss else None,
                                   slots=slots, data=self._data_tensor(data),
                                   row_offset=self._row_off, B=B, r=r, rb_ids=rb_ids))
            self._row_off += B * r

        groups: Dict[tuple, list] = {}
        for rb in active:
            fams = tuple(self._block_pos[id(b)][0] for b in rb.blocks)
            key = (id(rb.cost), id(rb.loss), fams, data_signature(rb.data))
            groups.setdefault(key, []).append(rb)
        for (_, _, fams, _), rbs in groups.items():
            slots = []
            for si, fi in enumerate(fams):
                fam = self.families[fi]
                pos = np.array([self._block_pos[id(rb.blocks[si])][1] for rb in rbs],
                               np.int64)
                slots.append(SlotPlan(fam, fi, pos, bool((pos < fam.num_var).any())))
            data = None
            if rbs[0].data is not None:
                if any(rb.data is None for rb in rbs):
                    raise ValueError("all residual blocks of a kind must carry data, "
                                     "or none")
                data = tree_stack([rb.data for rb in rbs],
                                  lambda leaves: np.stack([np.asarray(a) for a in leaves]))
            add_kind(rbs[0].cost, rbs[0].loss, slots, data, len(rbs),
                     np.array([rb.rb_id for rb in rbs], np.int64))

        self.batched_fixed = []
        for rec in records:
            if all(arr.constant for arr, _ in rec.slots):
                self.batched_fixed.append(rec)
                continue
            slots = [SlotPlan(self.families[fam_of_array[id(arr)]], fam_of_array[id(arr)],
                              idx.astype(np.int64), not arr.constant)
                     for arr, idx in rec.slots]
            add_kind(rec.cost, rec.loss, slots, rec.data, rec.B)
        self.num_residuals = self._row_off
        self._fixed_rbs = fixed
        self.fixed_cost = self._fixed_cost(fixed)

    def _fixed_cost(self, fixed) -> float:
        """The cost of the residual blocks whose parameters are all constant,
        in float64 on the CPU (program.py:434-467)."""
        total = 0.0

        def add(cost, loss, params, data):
            res = torch.func.vmap(lambda ps, d: cost.residuals(list(ps), d),
                                  in_dims=(0, None if data is None else 0))(params, data)
            s = torch.sum(res * res, dim=-1)
            if self.apply_loss and loss is not None:
                s = loss.evaluate(s)[0]
            return 0.5 * float(torch.sum(s))

        as_t = (lambda a: torch.as_tensor(np.asarray(a, np.float64))
                if np.issubdtype(np.asarray(a).dtype, np.floating)
                else torch.as_tensor(np.asarray(a)))
        for rb in fixed:
            params = tuple(torch.as_tensor(b.values)[None] for b in rb.blocks)
            data = tree_map(lambda a: as_t(a)[None], rb.data)
            total += add(rb.cost, rb.loss, params, data)
        for rec in self.batched_fixed:
            params = tuple(torch.as_tensor(arr.values[idx]) for arr, idx in rec.slots)
            total += add(rec.cost, rec.loss, params, tree_map(as_t, rec.data))
        return total

    # ---------------------------------------------------------------- state IO

    def _family_values(self, fam: Family) -> np.ndarray:
        if fam.array is not None:
            return fam.array.values.reshape(-1)
        return np.concatenate([b.values for b in fam.blocks])

    def initial_state(self) -> torch.Tensor:
        parts = [self._family_values(f) for f in self.families]
        if not parts:
            return torch.zeros((0,), dtype=torch.float64, device=self.device)
        return torch.as_tensor(np.concatenate(parts), dtype=torch.float64,
                               device=self.device)

    def write_state(self, x: torch.Tensor) -> None:
        """Write the solver state back into the caller's arrays."""
        xv = x.detach().to("cpu", torch.float64).numpy()
        for fam in self.families:
            table = xv[fam.state_offset:fam.state_offset + fam.count * fam.asize].reshape(
                fam.count, fam.asize)
            if fam.array is not None:
                fam.array.values[...] = table
            else:
                for b, row in zip(fam.blocks, table):
                    b.values[:] = row

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

    def make_args(self, pad_to: int = 1, rank: Optional[int] = None):
        """The per-kind observation arrays as arguments of _eval_core
        (program.py:531): [kind] {"pos": [slot] (B',) block rows in the
        family, "tangent_idx": [slot] (B', t) tangent columns, the tangent
        size for a constant block, "data": the data tree, "w": (B',) 1 or
        0}. Each kind is padded to a multiple of `pad_to` rows by repeating
        its last row with weight 0, and a padding row's tangent_idx is the
        sentinel. With `rank`, only that rank's shard of each kind: rows
        [rank B'/pad_to, (rank + 1) B'/pad_to)."""
        T = self.tangent_size
        args = []
        for k, kind in enumerate(self.kinds):
            B = kind.B
            Bp = B + (-B) % pad_to
            lo, hi = (0, Bp) if rank is None else (rank * Bp // pad_to,
                                                   (rank + 1) * Bp // pad_to)
            idx = np.minimum(np.arange(lo, hi), B - 1)
            real = np.arange(lo, hi) < B
            pos, tidx = [], []
            for s in kind.slots:
                fam, t = s.family, s.family.tsize
                p = s.pos_in_family[idx]
                cols = np.where((real & (p < fam.num_var))[:, None],
                                fam.tangent_offset + p[:, None] * t + np.arange(t), T)
                pos.append(torch.as_tensor(p, device=self.device))
                tidx.append(torch.as_tensor(cols.astype(np.int64), device=self.device))
            ix = torch.as_tensor(idx, device=self.device)
            args.append({"pos": pos, "tangent_idx": tidx,
                         "data": tree_map(lambda d: d[ix], kind.data),
                         "w": torch.as_tensor(real.astype(np.float64), device=self.device)})
        return args

    def _eval_core(self, x: torch.Tensor, dense_jac: bool = False,
                   with_jac: bool = True, row_costs: bool = False, args=None):
        """Plain evaluation: {"cost": f64 scalar, "residuals": (N,),
        "block_jacs": [kind][slot] (B, r, t)} in the compute dtype, and with
        `dense_jac` "jacobian", the dense (N, tangent) float64 Jacobian
        (program.py:565, the `dense_jac` branch), with
        tangent-space Jacobians (J_ambient PlusJacobian) and the kind's
        loss applied by the corrector: the cost is 1/2 sum rho(|r|^2), the
        residuals and Jacobians the corrected ones (program.py:620-642).
        Without `with_jac`, the cost and residuals only (the line search's
        probes). With `row_costs` a kind's cost is the sum of its rows'
        costs in the compute dtype, as the JAX evaluation adds them
        (program.py:617-637; the line-search minimizers read it); else the
        sum of the squared residuals in float64. Rows are evaluated
        EVAL_CHUNK_ROWS at a time, which bounds the memory of the batched
        forward-mode Jacobian and changes no value.

        With `args` (make_args, a rank's shard), the rows are the args':
        each row's residuals and Jacobians are multiplied by its weight
        before the loss (padding rows add 0), and the cost is the rows'
        own, without fixed_cost, which the caller adds once after summing
        over the ranks (program.py:565-570)."""
        assert args is None or not dense_jac
        xc = x.to(self.compute_dtype)
        total = torch.zeros((), dtype=torch.float64, device=x.device)
        plus_jacs = self._plus_jacobians(xc) if with_jac else {}
        res_chunks, block_jacs = [], []
        for k, kind in enumerate(self.kinds):
            tables = [self.family_table(xc, s.family) for s in kind.slots]
            trivial = kind.loss is None or isinstance(kind.loss, TrivialLoss)
            if args is None:
                pos_all, data_all, w_all, B = None, kind.data, None, kind.B
            else:
                pos_all, data_all = args[k]["pos"], args[k]["data"]
                w_all = args[k]["w"].to(self.compute_dtype)
                B = w_all.shape[0]
            parts = []
            for a in range(0, B, EVAL_CHUNK_ROWS):
                rows = slice(a, min(a + EVAL_CHUNK_ROWS, B))
                index = [(self._slot_index(k, s) if pos_all is None else pos_all[s])[rows]
                         for s in range(len(tables))]
                params = tuple(tab[i] for tab, i in zip(tables, index))
                data = tree_map(lambda d: d[rows], data_all)
                w = None if w_all is None else w_all[rows]
                if not with_jac:
                    res = torch.func.vmap(
                        lambda ps, d: kind.cost.residuals(list(ps), d),
                        in_dims=(0, None if data is None else 0))(params, data)
                    if w is not None:
                        res = res * w[:, None]
                    cost_b = None
                    if not trivial:
                        cost_b, res, _ = correct_residuals_and_jacobians(kind.loss, res, [])
                    parts.append((res, [], cost_b))
                    continue
                res, jacs = kind.cost.batched_residuals_and_jacobians(params, data)
                if w is not None:
                    res = res * w[:, None]
                    jacs = [J * w[:, None, None] for J in jacs]
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
                jacs = [torch.cat([p[1][s] for p in parts])
                        for s in range(len(parts[0][1]))]
                cost_b = None if parts[0][2] is None else torch.cat([p[2] for p in parts])
            block_jacs.append(list(jacs))
            if row_costs:
                if cost_b is None:
                    cost_b = 0.5 * torch.sum(res * res, dim=-1)
                total = total + torch.sum(cost_b).to(torch.float64)
            elif cost_b is None:
                total = total + 0.5 * torch.sum((res * res).to(torch.float64))
            else:
                total = total + torch.sum(cost_b.to(torch.float64))
            res_chunks.append(res.reshape(-1))
        out = {"cost": total + (self.fixed_cost if args is None else 0.0),
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

    def gradient(self, block_jacs, residuals) -> torch.Tensor:
        """J'r (tangent,) in float64, each slot's (B, t) products, formed
        in the compute dtype as the JAX evaluation forms them, added at its
        blocks' tangent columns, a constant block's into a dropped extra
        column (program.py:646-653)."""
        T = self.tangent_size
        if self._grad_index is None:
            idx = []
            for kind in self.kinds:
                per = []
                for s in kind.slots:
                    fam, t = s.family, s.family.tsize
                    pos = s.pos_in_family
                    cols = np.where((pos < fam.num_var)[:, None],
                                    fam.tangent_offset + pos[:, None] * t + np.arange(t), T)
                    per.append(torch.as_tensor(cols.reshape(-1), device=self.device))
                idx.append(per)
            self._grad_index = idx
        g = torch.zeros((T + 1,), dtype=torch.float64, device=self.device)
        for kind, jacs, per in zip(self.kinds, block_jacs, self._grad_index):
            rows = residuals[kind.row_offset:kind.row_offset + kind.B * kind.r].reshape(
                kind.B, kind.r)
            for s, J, ix in zip(kind.slots, jacs, per):
                if s.any_variable:
                    scatter_add_rows(g, ix, torch.einsum(
                        "brt,br->bt", J, rows.to(J.dtype)).reshape(-1).to(torch.float64))
        return g[:T]

    def evaluate_gradient(self, x):
        """(cost, gradient) in float64, the cost summed as the JAX
        evaluation sums it: what the line-search minimizers read."""
        o = self._eval_core(x, row_costs=True)
        return o["cost"], self.gradient(o["block_jacs"], o["residuals"])

    def evaluate_line_cost(self, x):
        """The cost as evaluate_gradient forms it."""
        return self._eval_core(x, with_jac=False, row_costs=True)["cost"]

    def evaluate_cost(self, x):
        return self._eval_core(x, with_jac=False)["cost"]

    def evaluate_residuals(self, x):
        o = self._eval_core(x, with_jac=False)
        return o["cost"], o["residuals"]

    def evaluate_dense(self, x):
        """(cost, residuals, gradient, dense tangent-space Jacobian)."""
        o = self._eval_core(x, dense_jac=True)
        return (o["cost"], o["residuals"],
                self.gradient(o["block_jacs"], o["residuals"]), o["jacobian"])

    def evaluate_bsr(self, x):
        """(cost, residuals, gradient, block Jacobians [kind][slot] (B, r, t))."""
        o = self._eval_core(x)
        return (o["cost"], o["residuals"],
                self.gradient(o["block_jacs"], o["residuals"]), o["block_jacs"])

    # ------------------------------------------------------- step application

    def has_bounds(self) -> bool:
        return any(f.lower is not None for f in self.families)

    def _box_tensors(self):
        if self._box is None:
            self._box = {i: (torch.as_tensor(f.lower, device=self.device),
                             torch.as_tensor(f.upper, device=self.device))
                         for i, f in enumerate(self.families) if f.lower is not None}
        return self._box

    def plus(self, x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
        """x [+] delta: the state x (state_size,) moved by a tangent step
        delta (tangent_size,) through each family's manifold, the variable
        blocks clipped to their box (program.py:744-770, ParameterBlock::Plus)."""
        if all(f.euclidean and f.num_var == f.count and f.lower is None
               for f in self.families):
            return x + delta
        box = self._box_tensors()
        parts = []
        for i, fam in enumerate(self.families):
            xf = self.family_table(x, fam)
            if fam.num_var > 0:
                n = fam.num_var * fam.tsize
                df = delta[fam.tangent_offset:fam.tangent_offset + n].reshape(
                    fam.num_var, fam.tsize)
                xv = xf[:fam.num_var]
                xv = xv + df if fam.euclidean else torch.func.vmap(fam.manifold.plus)(xv, df)
                if i in box:
                    xv = torch.clamp(xv, box[i][0], box[i][1])
                xf = torch.cat([xv, xf[fam.num_var:]]) if fam.num_var < fam.count else xv
            parts.append(xf.reshape(-1))
        return torch.cat(parts) if parts else x

    def ambient_bounds(self):
        """(lower, upper) over the whole state vector, infinite where
        unbounded (program.py:774-785)."""
        lo = np.full(self.state_size, -np.inf)
        hi = np.full(self.state_size, np.inf)
        for fam in self.families:
            if fam.lower is None:
                continue
            o, n = fam.state_offset, fam.num_var * fam.asize
            lo[o:o + n] = fam.lower.reshape(-1)
            hi[o:o + n] = fam.upper.reshape(-1)
        return lo, hi

    def tangent_box(self):
        """(tmap, lower, upper) over the tangent vector where bounds act
        1:1 (Euclidean families): tmap[i] the state index of tangent
        coordinate i, or -1 where no box applies; the active-set mask of the
        bounded loop reads it (program.py:787-812)."""
        tmap = np.full(self.tangent_size, -1, np.int64)
        lo = np.full(self.tangent_size, -np.inf)
        hi = np.full(self.tangent_size, np.inf)
        for fam in self.families:
            if fam.lower is None or not fam.euclidean or fam.asize != fam.tsize:
                continue
            n = fam.num_var * fam.tsize
            t0 = fam.tangent_offset
            tmap[t0:t0 + n] = fam.state_offset + np.arange(n)
            lo[t0:t0 + n] = fam.lower[:fam.num_var].reshape(-1)
            hi[t0:t0 + n] = fam.upper[:fam.num_var].reshape(-1)
        return tmap, lo, hi
