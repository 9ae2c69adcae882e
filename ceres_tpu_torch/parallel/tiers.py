"""The rank program that drives each multi-device tier once over one
process group (what parallel.mesh.launch runs on every rank):

    from ceres_tpu_torch.parallel import mesh, tiers
    out = mesh.launch(tiers.run_cases, 4, "gloo", device="cpu",
                      args=({"p": arrays}, [dict(name="pt", tier="point",
                                                 problem="p", num_iterations=3)]))

`problems` maps a name to the BAL arrays (cameras, points, camera_index,
point_index, observations); each case names its problem, its tier and
the tier's arguments. Every case runs twice from the same start, and its
result says whether the second run gave the same bits. A result holds
the tier's final cost, the state as global unpadded tables (gathered
over the ranks where the tier shards it), the kernels each run launched
on this rank (their plain versions' calls on the CPU), the collectives
the mesh called and the seconds of the first run; and the seconds of all
the cases, repeats included, and of the device's context made before
them; and the wall-clock times (time.time) at which the rank entered and
left run_cases.

run_world_sizes runs the cases at several world sizes from one launch:
the largest over every rank, the others side by side over subgroups of
the leading ranks, so that the ranks start once.

Tiers: "evaluator" (ShardedProgramEvaluator and one
sharded_gradient_descent_step), "solve_sharded", "solve_sharded_fused",
"solve_ba" (the observations sharded, the state replicated), "point",
"camera", "halo", "halo_ceres" and "program_halo" (quat=True for
quaternion cameras)."""
from __future__ import annotations

import copy
import time

import numpy as np
import torch

from . import mesh as pm
from . import sharded_ba as sb
from . import sharded_program as sp


def _bal(arrays, dtype=np.float64):
    from ..models import bal

    cams, pts, ci, pi, obs = arrays
    return bal.from_arrays(np.asarray(cams, dtype), np.asarray(pts, dtype), ci, pi,
                           np.asarray(obs, dtype))


def _problem(arrays, quat=False):
    from ..models import bal

    b = _bal(arrays)
    return (bal.build_problem_batched_quat if quat else bal.build_problem_batched)(b)


def _run(mesh, arrays, case):
    """One run of a case: {"cost", "cams", "pts", ...}."""
    from ..options import Options
    from ..program import CompiledProgram
    from ..solvers.fused_lm import solve_sharded_fused
    from ..types import LinearSolverType

    tier = case["tier"]
    kw = {k: v for k, v in case.items() if k not in ("name", "tier", "problem")}
    if tier == "evaluator":
        problem, _, _ = _problem(arrays, kw.pop("quat", False))
        program = CompiledProgram(problem, device=mesh.device)
        ev = pm.ShardedProgramEvaluator(program, mesh)
        x0 = program.initial_state()
        cost, g = ev.evaluate_grad(x0)
        x1, _ = pm.sharded_gradient_descent_step(ev, x0, kw.get("lr", 1e-6))
        return {"cost": float(cost), "gradient": g.cpu().numpy(),
                "x1": x1.cpu().numpy(), "cost_only": float(ev.evaluate_cost(x0))}
    if tier in ("solve_sharded", "solve_sharded_fused"):
        problem, cams, pts = _problem(arrays, kw.pop("quat", False))
        opts = Options(linear_solver_type=LinearSolverType.CGNR, **kw)
        fn = pm.solve_sharded if tier == "solve_sharded" else solve_sharded_fused
        s = fn(opts, problem, mesh)
        return {"cost": s.final_cost, "cams": cams, "pts": pts,
                "rows": [r.cost for r in s.iterations], "num_devices": s.num_devices,
                "termination": s.termination_type.name}
    if tier == "program_halo":
        problem, cams, pts = _problem(arrays, kw.pop("quat", False))
        program = CompiledProgram(problem, device=mesh.device)
        opts = sb.ShardedLMOptions(**kw.pop("options", {}))
        x, info, term = sp.solve_program_camera_halo(program, opts, mesh, **kw)
        return {"cost": info["final_cost"], "x": x, "cams": cams, "pts": pts,
                "iterations": info["iterations"], "termination": term.name}
    b = _bal(arrays)
    if tier == "solve_ba":
        st = sb.solve_ba(b, mesh=mesh, **kw)
        return {"cost": float(st.cost), "cams": st.cams.cpu().numpy(),
                "pts": st.pts.cpu().numpy()}
    if tier == "point":
        st, plan = sb.solve_ba_point_sharded(b, mesh=mesh, **kw)
        cams = st.cams.cpu().numpy()
        pts = pm.gather_padded(mesh, st.pts).cpu().numpy()[plan.point_slot]
        return {"cost": float(st.cost), "cams": cams, "pts": pts, "Pl": plan.Pl,
                "local_rows": int(st.pts.shape[0])}
    if tier in ("camera", "halo"):
        st, plan = sb.solve_ba_camera_sharded(b, mesh=mesh, halo=tier == "halo", **kw)
        out = {"plan": type(plan).__name__}
        if tier == "halo":
            # the cut: the distinct point rows this rank's observations
            # take from other ranks (the exchange moves n * Hs rows)
            ph = plan.pt_halo[mesh.rank * plan.Bl:(mesh.rank + 1) * plan.Bl]
            out.update(Hs=plan.Hs, cut_rows=int(np.unique(ph[ph // plan.Hs != mesh.rank]).size))
    elif tier == "halo_ceres":
        opts = sb.ShardedLMOptions(**kw.pop("options", {}))
        st, plan, term = sb.solve_ba_camera_halo_ceres(b, opts, mesh, **kw)
        out = {"termination": term.name}
    else:
        raise ValueError(f"unknown tier {tier!r}")
    cams = pm.gather_padded(mesh, st.cams).cpu().numpy()[plan.camera_slot]
    pts = pm.gather_padded(mesh, st.pts).cpu().numpy()[plan.point_slot]
    out.update(cost=float(st.cost), cams=cams, pts=pts, Pl=plan.Pl,
               local_rows=int(st.pts.shape[0]))
    return out


def _same_bits(a, b):
    if isinstance(a, dict):
        return all(_same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_bits(u, v) for u, v in zip(a, b))
    if isinstance(a, (np.ndarray, float)):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def run_cases(mesh, problems, cases):
    """Each case twice on this rank; returns {name: result}."""
    from ..ops import kernels as kn

    entered_at = time.time()
    t_all = time.perf_counter()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)  # the context, outside the first case
    t_context = time.perf_counter() - t_all
    out = {}
    for case in cases:
        arrays = problems[case["problem"]]
        runs = []
        for _ in range(2):
            kn.reset_counts()
            calls0 = dict(mesh.calls)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            t0 = time.perf_counter()
            res = _run(mesh, copy.deepcopy(arrays), case)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            res["seconds"] = time.perf_counter() - t0
            res["launches"] = {k.__name__: k.launches for k in kn.KERNELS if k.launches}
            res["plain_calls"] = {k.__name__: k.plain_calls for k in kn.KERNELS
                                  if k.plain_calls}
            res["collectives"] = {k: v - calls0[k] for k, v in mesh.calls.items()}
            runs.append(res)
        first = runs[0]
        first["repeat_bitwise"] = all(
            _same_bits(first[k], runs[1][k]) for k in first
            if k not in ("seconds", "launches", "plain_calls", "collectives"))
        out[case["name"]] = first
    return {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
            "device": str(mesh.device), "cases": out, "seconds": time.perf_counter() - t_all,
            "context_seconds": t_context, "entered_at": entered_at, "left_at": time.time()}


def run_world_sizes(mesh, problems, cases, sizes):
    """run_cases at each world size of `sizes` from one group of
    max(sizes) ranks: first over the whole group, then the other sizes
    side by side, each over a subgroup of consecutive ranks from rank 0
    (sizes 4, 2, 1: ranks 0-3, then ranks 0-1 beside rank 2). Returns
    {size: run_cases result} for the (sub)groups this rank is in."""
    import torch.distributed as dist

    big, *rest = sorted(sizes, reverse=True)
    if big != mesh.size or sum(rest) > mesh.size:
        raise ValueError(f"sizes {sizes} do not fit a group of {mesh.size} ranks")
    out = {big: run_cases(mesh, problems, cases)}
    start, mine = 0, None
    for n in rest:
        ranks = list(range(start, start + n))
        group = dist.new_group(ranks)  # every rank makes every subgroup
        if mesh.rank in ranks:
            mine = n, group
        start += n
    if mine is not None:
        n, group = mine
        sub = pm.make_mesh(n, mesh.axis, mesh.device, group)
        out[n] = run_cases(sub, problems, cases)
    return out
