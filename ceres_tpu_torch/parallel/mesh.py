"""Multi-device evaluation and solves on torch.distributed (counterpart of
ceres_tpu/parallel/mesh.py), and the mesh the sharded tiers run over.

The JAX tiers are single-controller programs: GSPMD or shard_map places
the collectives. Here each tier is the per-rank (SPMD) program, one
process per rank: a rank holds its shard of the observations (and, in
the point-, camera- and halo-sharded tiers of parallel/sharded_ba.py, of
the state), and every psum, tiled all-gather, tiled all-to-all and
axis_index of the JAX code is an explicit call on a `Mesh`. Where GSPMD
inserted the all-reduces (the generic evaluator, the sharded CGNR, the
sharded solve_ba), the port places them by hand: cost, gradient, column
norms, J'u and the model cost change each close with one `psum`.

Backends. The caller names one, and nothing switches it on an error:
`nccl` when each rank has a card of its own, `gloo` when ranks share a
card or run on the CPU (NCCL refuses two ranks on one card, and `launch`
refuses, before it spawns a rank, any world size or device that would
ask it to). `launch` binds each rank to its card (torch.cuda.set_device)
before anything else runs there, so that every tensor a rank makes
without naming a device, and every kernel it launches, lands on its own
card. gloo takes
every collective the mesh calls on CUDA tensors as they are (it stages
them through the host itself): scripts/gloo_cuda_probe.py found
all_reduce, all_gather_into_tensor, all_to_all_single, broadcast and
reduce_scatter_tensor accepted with two ranks on one H100 (PyTorch
2.11.0+cu128), so the mesh stages nothing.

Every decision a rank takes (accept or reject, a CG stop, termination)
is made on values that came out of one collective, or on replicated
tensors every rank computed from identical inputs, so that the ranks
branch alike: a rank that branches differently would hang the group.
`launch` turns such a hang into a failure: it joins the ranks under a
deadline and kills the group when the deadline passes.
"""
from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..program import resolve_device

COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "all_to_all_single", "broadcast")


class Mesh:
    """One axis over the ranks of an initialized process group (the
    default group, or `group`, one made by torch.distributed.new_group):
    the rank, the world size, the rank's device and the collectives the
    sharded tiers use. `calls` counts each collective's calls, `largest`
    the largest leading dimension of any operand of each (the tensor a
    rank passes in; 1 for a scalar). `start_seconds`: the rank's start as
    `launch` split it, empty where the process group was made otherwise."""

    def __init__(self, axis: str = "obs", device=None, group=None):
        if not dist.is_initialized():
            raise RuntimeError("make_mesh needs an initialized process group "
                               "(torch.distributed.init_process_group, or launch)")
        self.axis = axis
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available; pass device='cpu'")
            device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        self.device = resolve_device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("the nccl backend needs the ranks on cards")
        self.calls = dict.fromkeys(COLLECTIVES, 0)
        self.largest = dict.fromkeys(COLLECTIVES, 0)
        self.start_seconds = {}

    def axis_index(self) -> int:
        return self.rank

    def _call(self, name, fn, out, *inputs):
        self.calls[name] += 1
        rows = max(t.shape[0] if t.dim() else 1 for t in inputs or (out,))
        self.largest[name] = max(self.largest[name], rows)
        fn(out, *inputs)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of x over the ranks (all_reduce), on every rank."""
        return self._call("all_reduce", lambda t: dist.all_reduce(t, group=self.group),
                          x.detach().clone().contiguous())

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._call("all_reduce", lambda t: dist.all_reduce(
            t, op=dist.ReduceOp.MAX, group=self.group), x.detach().clone().contiguous())

    def all_gather_tiled(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' x stacked along the first axis, in rank order."""
        x = x.contiguous()
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        return self._call("all_gather_into_tensor", lambda o, i: dist.all_gather_into_tensor(
            o, i, group=self.group), out, x)

    def all_to_all_tiled(self, x: torch.Tensor) -> torch.Tensor:
        """Chunk j of x (its first axis cut into world-size equal chunks)
        goes to rank j; chunk i of the result came from rank i."""
        x = x.contiguous()
        out = torch.empty_like(x)
        return self._call("all_to_all_single", lambda o, i: dist.all_to_all_single(
            o, i, group=self.group), out, x)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """x of the mesh's rank src, on every rank."""
        src = src if self.group is None else dist.get_global_rank(self.group, src)
        return self._call("broadcast", lambda t: dist.broadcast(t, src, group=self.group),
                          x.detach().clone().contiguous())


def make_mesh(n_devices=None, axis: str = "obs", device=None, group=None) -> Mesh:
    """The mesh over the initialized process group (or its subgroup
    `group`); `n_devices`, when given, must be its world size.
    device=None: the rank's card."""
    mesh = Mesh(axis, device, group)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"the process group has {mesh.size} ranks, not {n_devices}")
    return mesh


def gather_padded(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The padded global table of a sharded state table (each rank's
    shard in rank order), on every rank: index it with a plan's
    camera_slot / point_slot."""
    return mesh.all_gather_tiled(t)


# --------------------------------------------------------------------------
# The launcher
# --------------------------------------------------------------------------


def _to_host(obj):
    """Tensors -> numpy arrays, through tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    return obj


def _rank_device(rank: int, device) -> torch.device:
    """The device of rank `rank`: device=None its own card, rank modulo
    the cards; else the device named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu'")
        return torch.device("cuda", rank % torch.cuda.device_count())
    return resolve_device(device)


def _rank_main(call_path, rank, world_size, backend, device, store, timeout_s, results,
               spawned_at):
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        start = {"spawn_to_entry": time.time() - spawned_at}
        # the ranks share the host's cores
        torch.set_num_threads(1)
        dev = _rank_device(rank, device)
        if dev.type == "cuda":
            t = time.perf_counter()
            torch.cuda.init()
            start["cuda_init"] = time.perf_counter() - t
            # the rank's card current before anything touches a card
            t = time.perf_counter()
            torch.cuda.set_device(dev)
            torch.cuda.synchronize(dev)
            start["context"] = time.perf_counter() - t
        t = time.perf_counter()
        # under NCCL device_id builds the communicator now, on the rank's card
        dist.init_process_group(backend, init_method=store, rank=rank,
                                world_size=world_size, timeout=timedelta(seconds=timeout_s),
                                device_id=dev if backend == "nccl" else None)
        start["process_group"] = time.perf_counter() - t
        try:
            mesh = make_mesh(device=dev)
            mesh.start_seconds = start
            out = fn(mesh, *args)
            results.put((rank, "ok", _to_host(out)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise


def _refuse(world_size: int, backend: str, device) -> None:
    """Raises, before any rank is spawned, for a backend, world size or
    device the ranks could not run on: NCCL takes one rank per card."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl":
        if device is not None:
            dev = torch.device(device)
            if dev.type != "cuda":
                raise ValueError(f"the nccl backend needs the ranks on cards, not on {dev}")
            if world_size > 1:
                raise ValueError(
                    f"the nccl backend takes one rank per card: device={device!r} names "
                    f"one card for {world_size} ranks (device=None gives rank r card r; "
                    "gloo shares a card)")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(f"the nccl backend takes one rank per card: {world_size} "
                             f"ranks, {cards} cards")
    elif device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu'")


def launch(fn: Callable, world_size: int, backend: str = "gloo", device=None,
           timeout_s: float = 300.0, args: tuple = ()):
    """Run fn(mesh, *args) on world_size ranks, each a spawned process,
    and return each rank's result (tensors as numpy arrays), in rank order.

    The ranks meet through a file store in a fresh temporary directory (no
    port to collide on) with `timeout_s` given to init_process_group. The
    parent waits for every result under a deadline of `timeout_s`: a rank
    that raises, dies or is still running at the deadline (one stuck in a
    collective) fails the call with RuntimeError or TimeoutError, and the
    whole group is killed. `fn` must be importable (a module-level function
    of an importable module). device: None for each rank's card
    (rank % device_count), or "cpu", "cuda:0" ... for every rank; each
    rank makes its card current before anything else, and under NCCL
    builds its communicator there at once. The backend is the caller's:
    nothing falls back to another on an error. NCCL takes one rank per
    card: ValueError, before any rank starts, for more ranks than cards,
    for one card named for several ranks, or for the CPU. Each rank's
    mesh.start_seconds splits its start: spawn to entry (the interpreter,
    import torch, the rank's modules, fn and args), CUDA's initialization
    in torch, its card's first context, init_process_group."""
    _refuse(world_size, backend, device)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ct_mesh_")
    store = "file://" + os.path.join(tmp, "store")
    # the ranks read fn and args from a file: a spawned process's own
    # arguments go through a pipe that blocks start() until the child has
    # imported its modules and read them, which started the ranks one
    # after another
    call_path = os.path.join(tmp, "call.pkl")
    with open(call_path, "wb") as f:
        pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
    results = ctx.Queue()
    procs, out, err = [], {}, None
    try:
        for r in range(world_size):
            procs.append(ctx.Process(target=_rank_main, daemon=True, args=(
                call_path, r, world_size, backend, device, store, timeout_s, results,
                time.time())))
            procs[-1].start()
        deadline = time.monotonic() + timeout_s
        while len(out) < world_size and err is None:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"mesh launch: ranks {sorted(set(range(world_size)) - set(out))} "
                    f"gave no result within {timeout_s} s")
            try:
                rank, status, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive() and p.exitcode not in (None, 0)]
                if dead:
                    # its message may still be in the queue: read it first
                    try:
                        rank, status, value = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(f"mesh launch: rank {dead[0]} died with exit "
                                           f"code {procs[dead[0]].exitcode}") from None
                else:
                    continue
            if status == "ok":
                out[rank] = value
            else:
                err = [(rank, value)]
        if err is not None:
            # the others' failures, often their collectives' loss of the
            # failed rank, follow within moments: report every rank's
            t_end = time.monotonic() + 2.0
            while len(err) + len(out) < world_size and time.monotonic() < t_end:
                try:
                    rank, status, value = results.get(timeout=0.2)
                except queue.Empty:
                    continue
                if status != "ok":
                    err.append((rank, value))
            raise RuntimeError("mesh launch: " + "\n".join(
                f"rank {r} failed:\n{tb}" for r, tb in sorted(err)))
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# Generic sharded evaluation and the sharded host loop (mesh.py:30-271)
# --------------------------------------------------------------------------


class ShardedProgramEvaluator:
    """Cost and gradient of a CompiledProgram with the observations
    sharded over the mesh and the state replicated: each rank evaluates
    its rows of make_args(pad_to=world size) and the cost and J'r close
    with one psum each. The program must live on the rank's device."""

    def __init__(self, program, mesh: Mesh):
        self.program = program
        self.mesh = mesh
        self.args = program.make_args(pad_to=mesh.size, rank=mesh.rank)
        self.kind_shapes = [(a["w"].shape[0], k.r) for a, k in zip(self.args, program.kinds)]

    def _gradient(self, o):
        from ..ops import bsr

        g = bsr.left_multiply_args(self.kind_shapes, self.args, o["block_jacs"],
                                   o["residuals"], self.program.tangent_size)
        return self.mesh.psum(g.to(torch.float64))

    def _cost(self, o):
        return self.mesh.psum(o["cost"]) + self.program.fixed_cost

    def evaluate_grad(self, x):
        o = self.program._eval_core(x, args=self.args)
        return self._cost(o), self._gradient(o)

    def evaluate_cost(self, x):
        return self._cost(self.program._eval_core(x, with_jac=False, args=self.args))

    def plus(self, x, delta):
        return self.program.plus(x, delta)


def sharded_gradient_descent_step(evaluator: ShardedProgramEvaluator, x, lr):
    """One step of the multichip dry run: the sharded cost and gradient,
    then x [+] (-lr g)."""
    cost, g = evaluator.evaluate_grad(x)
    return evaluator.plus(x, -lr * g), cost


class ShardedBlockKernels(ShardedProgramEvaluator):
    """The host trust-region loop's kernels (solvers/trust_region.py) with
    the evaluation and the CGNR solve sharded over the mesh: each rank's
    Jacobian blocks stay on it, J'u, the column norms and the model cost
    change close with one psum each, and CG's vectors are replicated. The
    preconditioner is scalar Jacobi diag(J'J + D^2)^{-1}, as mesh.py:87
    has it."""

    def __init__(self, program, options, mesh: Mesh):
        super().__init__(program, mesh)
        self.options = options

    def _left(self, values, u):
        from ..ops import bsr

        return self.mesh.psum(bsr.left_multiply_args(self.kind_shapes, self.args, values, u,
                                                     self.program.tangent_size))

    def _sqn(self, values):
        from ..ops import bsr

        return self.mesh.psum(bsr.squared_column_norm_args(
            self.kind_shapes, self.args, values, self.program.tangent_size))

    def eval_full(self, x):
        """(cost, this rank's residuals, gradient, its Jacobian blocks,
        |gradient|, max |gradient|)."""
        from ..solvers.trust_region import grad_norms

        o = self.program._eval_core(x, args=self.args)
        g = self._gradient(o)
        gnorm, gmax = grad_norms(self.program, x, g)
        return self._cost(o), o["residuals"], g, o["block_jacs"], gnorm, gmax

    def jacobi_scale(self, values):
        return 1.0 / (1.0 + torch.sqrt(self._sqn(values)))

    def lm_diagonal(self, values, scale):
        from ..ops import bsr

        vs = bsr.scale_columns_args(self.args, values, scale)
        return torch.clamp(self._sqn(vs), self.options.min_lm_diagonal,
                           self.options.max_lm_diagonal)

    def compute_step(self, values, residuals, scale, diagonal, radius, fetch):
        """(step, step * scale, model cost change, CG iterations)."""
        from ..ops import bsr
        from ..solvers.linear.cg import conjugate_gradients

        opts = self.options
        vs = bsr.scale_columns_args(self.args, values, scale)
        D = torch.sqrt(diagonal / radius)

        def right(v):
            return bsr.right_multiply_args(self.kind_shapes, self.args, vs, v)

        def lhs(v):
            return self._left(vs, right(v)) + (D * D) * v

        rhs = self._left(vs, residuals)
        minv = 1.0 / (diagonal + D * D)
        res = conjugate_gradients(
            lhs, rhs, torch.zeros_like(rhs), lambda v: minv * v, fetch=fetch,
            min_num_iterations=opts.min_linear_solver_iterations,
            max_num_iterations=opts.max_linear_solver_iterations,
            residual_reset_period=10, r_tolerance=-1.0, q_tolerance=opts.eta)
        step = -res.x
        mr = right(step)
        mcc = self.mesh.psum(-torch.dot(mr, residuals.to(mr.dtype) + mr / 2.0))
        return step, step * scale, mcc, res.num_iterations

    def candidate(self, x, delta):
        cx = self.program.plus(x, delta.to(torch.float64))
        return cx, self.evaluate_cost(cx), torch.linalg.vector_norm(x - cx)

    def cost_at(self, x, delta):
        return self.evaluate_cost(self.program.plus(x, delta.to(torch.float64)))


def solve_sharded(options, problem, mesh: Optional[Mesh] = None, summary=None):
    """solve() with the trust-region inner math sharded over the mesh:
    evaluation, gradients and the CGNR loop (mesh.py:235), under the host
    trust-region loop. Every rank runs it on the same problem and options
    and returns the same Summary; each writes the solution into its own
    process's arrays."""
    from ..program import CompiledProgram
    from ..solvers.trust_region import TrustRegionMinimizer
    from ..summary import Summary

    if summary is None:
        summary = Summary()
    if mesh is None:
        mesh = make_mesh()
    t0 = time.monotonic()
    program = CompiledProgram(problem, device=mesh.device)
    summary.fixed_cost = program.fixed_cost
    summary.num_devices = mesh.size
    kernels = ShardedBlockKernels(program, options, mesh)
    summary.preprocessor_time_in_seconds = time.monotonic() - t0
    minimizer = TrustRegionMinimizer(program, kernels, options, summary)
    x = minimizer.minimize(program.initial_state())
    program.write_state(x)
    if np.isfinite(minimizer.x_cost):
        summary.final_cost = minimizer.x_cost
    summary.total_time_in_seconds = time.monotonic() - t0
    return summary
