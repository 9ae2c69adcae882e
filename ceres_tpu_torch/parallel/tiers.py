"""The rank program that drives each multi-device tier once over one
process group (what parallel.mesh.launch runs on every rank):

    from ceres_tpu_torch.parallel import mesh, tiers
    out = mesh.launch(tiers.run_cases, 4, "gloo", device="cpu",
                      args=({"p": arrays}, [dict(name="pt", tier="point",
                                                 problem="p", num_iterations=3)]))

`problems` maps a name to the BAL arrays (cameras, points, camera_index,
point_index, observations); each case names its problem, its tier and
the tier's arguments (a case with "sizes" runs only at those world
sizes). Every case runs twice from the same start, and its result says
whether the second run gave the same bits. A result holds the tier's
final cost, the state as global unpadded tables (gathered over the ranks
where the tier shards it), the LM iterations and the CG budget, the
devices of the tensors the tier returned, the kernels each run launched
on this rank (their plain versions' calls on the CPU), the collectives
the mesh called with the largest leading dimension of each one's
operands, the peak device memory and the seconds of the first run; and
the seconds of all the cases, repeats included, the rank's current
card, its start as parallel.mesh.launch split it, and the wall-clock
times (time.time) at which the rank entered and left run_cases.
`audit` holds a result's collectives to the bounds of the JAX package's
collective audit.

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


def _devices(obj) -> set:
    """The devices of the tensors in obj, through tuples, lists and dicts."""
    if isinstance(obj, torch.Tensor):
        return {str(obj.device)}
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return set().union(*map(_devices, obj))
    return set()


def _lm_iterations(kw):
    """The LM iterations of a tier that steps k at a time until it has run
    num_iterations."""
    k = kw.get("k") or kw["num_iterations"]
    return -(-kw["num_iterations"] // k) * k


def _run(mesh, arrays, case):
    """One run of a case: {"cost", "cams", "pts", "iterations", "cg",
    "devices", ...}."""
    from ..options import Options
    from ..program import CompiledProgram
    from ..solvers.fused_lm import solve_sharded_fused
    from ..types import LinearSolverType

    tier = case["tier"]
    kw = {k: v for k, v in case.items() if k not in ("name", "tier", "problem", "sizes")}
    if tier == "evaluator":
        problem, _, _ = _problem(arrays, kw.pop("quat", False))
        program = CompiledProgram(problem, device=mesh.device)
        ev = pm.ShardedProgramEvaluator(program, mesh)
        x0 = program.initial_state()
        cost, g = ev.evaluate_grad(x0)
        x1, _ = pm.sharded_gradient_descent_step(ev, x0, kw.get("lr", 1e-6))
        return {"cost": float(cost), "gradient": g.cpu().numpy(),
                "x1": x1.cpu().numpy(), "cost_only": float(ev.evaluate_cost(x0)),
                "iterations": 1, "cg": None, "devices": _devices((cost, g, x1))}
    if tier in ("solve_sharded", "solve_sharded_fused"):
        problem, cams, pts = _problem(arrays, kw.pop("quat", False))
        opts = Options(linear_solver_type=LinearSolverType.CGNR, **kw)
        fn = pm.solve_sharded if tier == "solve_sharded" else solve_sharded_fused
        s = fn(opts, problem, mesh)
        return {"cost": s.final_cost, "cams": cams, "pts": pts,
                "rows": [r.cost for r in s.iterations], "num_devices": s.num_devices,
                "termination": s.termination_type.name,
                "iterations": len(s.iterations) - 1, "cg": opts.max_linear_solver_iterations,
                "devices": set()}
    if tier == "program_halo":
        problem, cams, pts = _problem(arrays, kw.pop("quat", False))
        program = CompiledProgram(problem, device=mesh.device)
        opts = sb.ShardedLMOptions(**kw.pop("options", {}))
        x, info, term = sp.solve_program_camera_halo(program, opts, mesh, **kw)
        plan = info["plan"]
        return {"cost": info["final_cost"], "x": x, "cams": cams, "pts": pts,
                "iterations": info["iterations"], "termination": term.name,
                "cg": opts.max_linear_solver_iterations, "P_pad": plan.pts.shape[0],
                "n": plan.n, "Hs": plan.Hs, "result_gathers": 2,
                "devices": _devices(program.initial_state())}
    b = _bal(arrays)
    if tier == "solve_ba":
        st = sb.solve_ba(b, mesh=mesh, **kw)
        return {"cost": float(st.cost), "cams": st.cams.cpu().numpy(),
                "pts": st.pts.cpu().numpy(), "iterations": kw["num_iterations"],
                "cg": kw.get("cg_iters", 10) if kw.get("step") == "cg" else None,
                "devices": _devices(st)}
    if tier == "point":
        st, plan = sb.solve_ba_point_sharded(b, mesh=mesh, **kw)
        cams = st.cams.cpu().numpy()
        pts = pm.gather_padded(mesh, st.pts).cpu().numpy()[plan.point_slot]
        return {"cost": float(st.cost), "cams": cams, "pts": pts, "Pl": plan.Pl,
                "local_rows": int(st.pts.shape[0]), "iterations": _lm_iterations(kw),
                "cg": None, "result_gathers": 1, "devices": _devices(st)}
    if tier in ("camera", "halo"):
        st, plan = sb.solve_ba_camera_sharded(b, mesh=mesh, halo=tier == "halo", **kw)
        out = {"plan": type(plan).__name__, "cg": kw.get("cg_iters", 10),
               "iterations": _lm_iterations(kw)}
        if tier == "halo":
            # the cut: the distinct point rows this rank's observations
            # take from other ranks (the exchange moves n * Hs rows)
            ph = plan.pt_halo[mesh.rank * plan.Bl:(mesh.rank + 1) * plan.Bl]
            out.update(Hs=plan.Hs, n=plan.n,
                       cut_rows=int(np.unique(ph[ph // plan.Hs != mesh.rank]).size))
    elif tier == "halo_ceres":
        opts = sb.ShardedLMOptions(**kw.pop("options", {}))
        info = {}
        st, plan, term = sb.solve_ba_camera_halo_ceres(b, opts, mesh, info=info, **kw)
        out = {"termination": term.name, "iterations": info["iterations"], "Hs": plan.Hs,
               "n": plan.n, "cg": opts.max_linear_solver_iterations}
    else:
        raise ValueError(f"unknown tier {tier!r}")
    out["devices"] = _devices(st)
    cams = pm.gather_padded(mesh, st.cams).cpu().numpy()[plan.camera_slot]
    pts = pm.gather_padded(mesh, st.pts).cpu().numpy()[plan.point_slot]
    out.update(cost=float(st.cost), cams=cams, pts=pts, Pl=plan.Pl,
               local_rows=int(st.pts.shape[0]), P_pad=plan.pts.shape[0], result_gathers=2)
    return out


def _same_bits(a, b):
    if isinstance(a, dict):
        return all(_same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_bits(u, v) for u, v in zip(a, b))
    if isinstance(a, (np.ndarray, float)):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


# the fields of a result that are not the tier's answer: left out of the
# repeat's comparison
_BOOKKEEPING = ("seconds", "launches", "plain_calls", "collectives", "largest", "peak_bytes")


def run_cases(mesh, problems, cases):
    """Each case twice on this rank; returns {name: result}."""
    from ..ops import kernels as kn

    entered_at = time.time()
    t_all = time.perf_counter()
    cuda = mesh.device.type == "cuda"
    out = {}
    for case in cases:
        if mesh.size not in case.get("sizes", (mesh.size,)):
            continue
        arrays = problems[case["problem"]]
        runs = []
        for _ in range(2):
            kn.reset_counts()
            calls0 = dict(mesh.calls)
            mesh.largest = dict.fromkeys(pm.COLLECTIVES, 0)
            if cuda:
                torch.cuda.synchronize(mesh.device)
                torch.cuda.reset_peak_memory_stats(mesh.device)
            t0 = time.perf_counter()
            res = _run(mesh, copy.deepcopy(arrays), case)
            if cuda:
                torch.cuda.synchronize(mesh.device)
            res["seconds"] = time.perf_counter() - t0
            res["peak_bytes"] = torch.cuda.max_memory_allocated(mesh.device) if cuda else 0
            res["devices"] = sorted(res["devices"])
            res["launches"] = {k.__name__: k.launches for k in kn.KERNELS if k.launches}
            res["plain_calls"] = {k.__name__: k.plain_calls for k in kn.KERNELS
                                  if k.plain_calls}
            res["collectives"] = {k: v - calls0[k] for k, v in mesh.calls.items()}
            res["largest"] = dict(mesh.largest)
            runs.append(res)
        first = runs[0]
        first["repeat_bitwise"] = all(
            _same_bits(first[k], runs[1][k]) for k in first if k not in _BOOKKEEPING)
        out[case["name"]] = first
    return {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
            "device": str(mesh.device),
            "current_device": torch.cuda.current_device() if cuda else None,
            "cases": out, "seconds": time.perf_counter() - t_all,
            "start_seconds": dict(mesh.start_seconds), "entered_at": entered_at,
            "left_at": time.time()}


# LM iterations' collectives, as the JAX package's audit bounds its tiers'
# compiled steps (tests/test_collective_audit.py:54-242), cg the case's
# CG budget; None: no bound
AUDITED = ("evaluator", "point", "camera", "halo", "halo_ceres", "program_halo")


def audit(tier, r):
    """(each collective's calls per LM iteration, the bounds r breaks: a
    list of strings, empty when all hold) for a run_cases result r of
    `tier`, one of AUDITED. The all-gathers that assemble the result's
    tables after the iterations (r["result_gathers"]) are left out:
    point-sharded: no all-to-all, 1-10 all-reduces, no all-gather (so
    none of the P_pad-row point table); camera-sharded: no all-to-all,
    1-2 all-gathers, at most 8 + 4 cg all-reduces; the evaluator: no
    all-to-all, at least one all-reduce; the halo tiers: no all-gather,
    1 to 6 + 2 cg all-to-alls, each of n * Hs rows at most (the cut), and
    no all-reduce of P_pad rows."""
    c, it = r["collectives"], r["iterations"]
    gathers = c["all_gather_into_tensor"] - r.get("result_gathers", 0)
    per = {k: v / it for k, v in c.items()}
    per["all_gather_into_tensor"] = gathers / it
    a2a, ar, ag = per["all_to_all_single"], per["all_reduce"], per["all_gather_into_tensor"]
    bad = []

    def need(ok, what):
        if not ok:
            bad.append(f"{tier}: {what} ({_calls_text(per)} per LM iteration)")

    if tier == "evaluator":
        need(a2a == 0, "an all-to-all")
        need(c["all_reduce"] >= 1, "no all-reduce")
    elif tier == "point":
        need(a2a == 0, "an all-to-all")
        need(1 <= ar <= 10, "all-reduces outside 1-10")
        need(gathers == 0, "an all-gather inside the iterations")
    elif tier == "camera":
        need(a2a == 0, "an all-to-all")
        need(1 <= ag <= 2, "all-gathers outside 1-2")
        need(1 <= ar <= 8 + 4 * r["cg"], f"all-reduces outside 1-{8 + 4 * r['cg']}")
    elif tier in ("halo", "halo_ceres", "program_halo"):
        cut = r["n"] * r["Hs"]
        need(gathers == 0, "an all-gather inside the iterations")
        need(1 <= a2a <= 6 + 2 * r["cg"], f"all-to-alls outside 1-{6 + 2 * r['cg']}")
        need(r["largest"]["all_to_all_single"] <= cut,
             f"an all-to-all of {r['largest']['all_to_all_single']} rows, over the cut {cut}")
        need(r["largest"]["all_reduce"] < r["P_pad"],
             f"an all-reduce of {r['largest']['all_reduce']} rows (P_pad {r['P_pad']})")
    else:
        raise ValueError(f"the audit has no bounds for tier {tier!r}")
    return per, bad


def _calls_text(per):
    return ", ".join(f"{k} {v:g}" for k, v in per.items())


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
        sub.start_seconds = mesh.start_seconds
        out[n] = run_cases(sub, problems, cases)
    return out
