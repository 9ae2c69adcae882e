"""Smoke run of ceres_tpu_torch on one NVIDIA GPU: builds the CUDA kernels
from the sources, holds each kernel against its plain PyTorch version at
BAL-16's real inputs, solves BAL-16 through the public `solve()` in float64
(the golden gate) and float32, counts what the solves launched, and times
the kernels and the LM iteration.

    python3 chip_smoke.py

Exits nonzero on any failure, and before printing any result when no CUDA
device is available. Its last line is {"ok": true, "device": {...}}; the
line before it lists every kernel with its launches, error and times.
Imports nothing of jax and nothing of ceres_tpu.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# bench_golden.json, "bal16_dense_schur_f64": BAL-16 DENSE_SCHUR in float64
GOLDEN_COST = 51931.10068031216
GOLDEN_ROWS = 17
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# peak rate of each type (NVIDIA H100 SXM data sheet, dense): float32
# outside the tensor cores, float64 on them (FP64 tensor-core DMMA)
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
REL_LIMIT = {torch.float64: 1e-11, torch.float32: 1e-4}

KERNELS = [
    ("eval_fused", "ceres_tpu/ops/pallas_kernels.py:2066"),
    ("post_eval_fused", "ceres_tpu/ops/pallas_kernels.py:1780"),
    ("schur_assembly", "ceres_tpu/ops/pallas_kernels.py:1281"),
    ("normal_matvec", "ceres_tpu/ops/pallas_kernels.py:781"),
]
# why no single PyTorch call computes each kernel's function
NO_LIBRARY_CALL = {
    "eval_fused": "no PyTorch call evaluates a residual and its Jacobian",
    "post_eval_fused": "five reductions (g, column norms, E'E) in one pass",
    "schur_assembly": "no call forms the Schur complement of a block-sparse J",
    "normal_matvec": "(J'J)x of a sparse J needs two products, J x then J'(Jx)",
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(tag, msg):
    print(f"[{tag}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0].strip()


def time_cuda(fn, n):
    """Milliseconds per call on the device: warm up, keep the card busy with
    a sleep kernel while the host enqueues n calls, then time the n calls
    between CUDA events, so that host dispatch is not in the figure."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (n * host_s * 1.5 + 2e-3)))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def rel_err(ref, out):
    """max over outputs of max|out - ref| / max|ref|, and max|out - ref|."""
    rel, mabs = 0.0, 0.0
    for a, b in zip(ref, out):
        check(a.shape == b.shape, f"shape {tuple(b.shape)} != {tuple(a.shape)}")
        err = (a.double() - b.double()).abs().max().item()
        scale = a.double().abs().max().item()
        check(np.isfinite(err), "non-finite kernel output")
        rel = max(rel, err / max(scale, 1e-300))
        mabs = max(mabs, err)
    return rel, mabs


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.models import bal
    from ceres_tpu_torch.ops import build
    from ceres_tpu_torch.ops import kernels as kn
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solver import _pick_linear_solver
    from ceres_tpu_torch.solvers.fused_lm import DenseSchurStepOps, JTForm
    from ceres_tpu_torch.summary import Summary

    dev = torch.device("cuda", 0)
    card = card_line()
    log("card", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"matmul allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # -- build ----------------------------------------------------------------
    info = build.build()
    log("build", f"{len(info.ptxas)} sources in {info.seconds:.2f} s "
        f"(reused={info.reused}) -> {info.path.name}")
    for src, text in info.ptxas.items():
        for line in text.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill")):
                log(f"ptxas {src}", line.strip())
    build.load()

    # -- BAL-16 and the kernels against their plain versions ------------------
    b16 = bal.bal16()
    log("bal16", f"cameras {b16.num_cameras}, points {b16.num_points}, "
        f"observations {b16.num_observations}")
    opts = ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR)
    rng = np.random.default_rng(7)
    checks, inputs = {}, {}
    for dtn in ("float64", "float32"):
        problem = bal.build_problem_batched(b16)[0]
        prog = CompiledProgram(problem, dtn, device=dev)
        _, e_fams = _pick_linear_solver(opts, prog, Summary())
        ops = DenseSchurStepOps(prog, opts, e_fams)
        plan, q, dt = ops.flat.plan, ops._jt_qual, prog.compute_dtype
        x0 = prog.initial_state()
        cams = prog.family_table(x0, q.fam_f).to(dt).contiguous()
        pts = prog.family_table(x0, q.fam_e).to(dt).contiguous()
        obs = prog.kinds[0].data
        P, C = plan.P, plan.C
        _, rT, JT = kn.eval_fused_plain(cams, pts, obs, plan, q.rows_fn)
        g, sqn, aux = ops.post_eval(JTForm(JT, rT))
        sqn64 = sqn.to(torch.float64)
        scale_c = (1.0 / (1.0 + torch.sqrt(sqn64))).to(dt)
        D2_c = (torch.clamp(scale_c.double() ** 2 * sqn64, 1e-6, 1e32) / 1e4).to(dt)
        _, se, sf, _, K, u_vec = ops.schur_inputs(aux, g, scale_c, D2_c)
        xc = (sf * torch.as_tensor(rng.standard_normal(C * 9), device=dev)
              .to(dt)).reshape(C, 9).contiguous()
        xp = (se * torch.as_tensor(rng.standard_normal(P * 3), device=dev)
              .to(dt)).reshape(P, 3).contiguous()
        args = {
            "eval_fused": (cams, pts, obs, plan, q.rows_fn),
            "post_eval_fused": (JT, rT, plan),
            "schur_assembly": (JT, sf.reshape(C, 9).contiguous(),
                               se.reshape(P, 3).contiguous(), K.contiguous(),
                               u_vec.reshape(P, 3).contiguous(), plan),
            "normal_matvec": (JT, xc, xp, plan),
        }
        inputs[dtn] = args
        for name, _ in KERNELS:
            wrapper = getattr(kn, name)
            plain = getattr(kn, name + "_plain")
            ref = plain(*args[name])
            torch.cuda.synchronize()
            out = wrapper(*args[name])
            torch.cuda.synchronize()
            rel, mabs = rel_err(ref, out)
            limit = REL_LIMIT[dt]
            log("check", f"{name} {dtn}: max over outputs of max_abs_err/max_abs "
                f"= {rel:.3e} (limit {limit:.0e}), max_abs_err {mabs:.3e}")
            check(rel <= limit, f"{name} {dtn} disagrees with its plain version")
            checks[(name, dtn)] = (rel, mabs, plan)

    # -- the main path: solve() on BAL-16 --------------------------------------
    solves = {}
    for dtn in ("float64", "float32"):
        problem = bal.build_problem_batched(bal.bal16())[0]
        o = ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                        evaluation_dtype=dtn)
        kn.reset_counts()
        s = ctt.solve(o, problem)
        torch.cuda.synchronize()
        launches = {n: getattr(kn, n).launches for n, _ in KERNELS}
        plain_calls = {n: getattr(kn, n).plain_calls for n, _ in KERNELS}
        n_it = len(s.iterations) - 1
        gap = (s.final_cost - GOLDEN_COST) / GOLDEN_COST
        res = {"iterations": n_it, "summary_rows": len(s.iterations),
               "termination": str(s.termination_type), "message": s.message,
               "initial_cost": s.initial_cost, "final_cost": s.final_cost,
               "gap_to_golden": gap, "host_syncs": s.num_host_syncs,
               "host_syncs_per_iteration": s.num_host_syncs / max(n_it, 1),
               "launches": launches, "plain_calls": plain_calls}
        log(f"solve {dtn}", json.dumps(res))
        check(all(v == 0 for v in plain_calls.values()),
              f"{dtn} solve ran a plain version on the card")
        check(n_it >= 1 and all(v >= n_it for v in launches.values()),
              f"{dtn} solve: a kernel launched fewer than once per iteration")
        if dtn == "float64":
            check(s.termination_type == ctt.TerminationType.CONVERGENCE,
                  "float64 solve did not converge")
            check(abs(gap) <= 1e-6, f"float64 final cost off golden by {gap:.3e}")
            log("solve float64", f"summary rows {len(s.iterations)} "
                f"(golden {GOLDEN_ROWS}), relative gap {gap:.3e} (limit 1e-6)")
        else:
            check(abs(gap) <= 1e-5, f"float32 final cost off golden by {gap:.3e}")
            log("solve float32", f"relative gap to the float64 golden {gap:.3e} "
                "(limit 1e-5)")
        solves[dtn] = res

    # -- ms per LM iteration, median of 5 solves ---------------------------
    for dtn in ("float64", "float32"):
        per_it = []
        for _ in range(5):
            problem = bal.build_problem_batched(bal.bal16())[0]
            s = ctt.solve(ctt.Options(
                linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                evaluation_dtype=dtn), problem)
            torch.cuda.synchronize()
            per_it.append(1e3 * s.minimizer_time_in_seconds / (len(s.iterations) - 1))
        solves[dtn]["ms_per_iteration_runs"] = per_it
        solves[dtn]["ms_per_iteration_median"] = statistics.median(per_it)
        log(f"solve {dtn}", "ms per LM iteration (minimizer time / iterations) "
            f"over 5 solves: median {statistics.median(per_it):.4f}, runs "
            + ", ".join(f"{v:.4f}" for v in per_it))

    # -- device busy share over one float64 solve -------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    problem = bal.build_problem_batched(bal.bal16())[0]
    o64 = ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR)
    ctt.solve(o64, problem)  # warm
    problem = bal.build_problem_batched(bal.bal16())[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s = ctt.solve(o64, problem)
        torch.cuda.synchronize()
    busy_us, n_ops, by_name = 0.0, 0, {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            busy_us += evt.device_time_total
            n_ops += 1
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.device_time_total
    n_it = len(s.iterations) - 1
    wall_ms = 1e3 * s.minimizer_time_in_seconds
    profile_res = {"minimizer_ms": wall_ms, "iterations": n_it}
    if busy_us > 0:
        profile_res.update(device_busy_ms=busy_us / 1e3,
                           device_busy_share=busy_us / 1e3 / wall_ms,
                           device_ops_per_iteration=n_ops / max(n_it, 1),
                           top_device_ms_per_iteration={
                               k[:80]: v / 1e3 / max(n_it, 1) for k, v in
                               sorted(by_name.items(), key=lambda kv: -kv[1])[:10]})
    else:
        profile_res["device_busy_share"] = "not measured"
    log("profile float64", json.dumps(profile_res))

    # -- kernel times -----------------------------------------------------
    rows = []
    for name, replaces in KERNELS:
        entry = {"name": name, "route": "cuda",
                 "source": f"ceres_tpu_torch/csrc/{name}.cu", "replaces": replaces,
                 "launches": solves["float64"]["launches"][name]}
        for dtn, suffix in (("float64", ""), ("float32", "_f32")):
            args = inputs[dtn]
            wrapper = getattr(kn, name)
            plain = getattr(kn, name + "_plain")
            rel, mabs, plan = checks[(name, dtn)]
            ms = time_cuda(lambda: wrapper(*args[name]), 100)
            plain_ms = time_cuda(lambda: plain(*args[name]), 10)
            byts, flops = work(name, args[name], plan)
            dt = args[name][0].dtype
            t_bytes = byts / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dt] * 1e3
            entry.update({
                "max_abs_err" + suffix: mabs, "rel_err" + suffix: rel,
                "ms" + suffix: ms, "plain_ms" + suffix: plain_ms,
                "bound_ms" + suffix: max(t_bytes, t_ops),
                "bound_by" + suffix: "bytes" if t_bytes >= t_ops else "operations",
                "library_ms" + suffix: None,
            })
            log("time", f"{name} {dtn}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"bound {max(t_bytes, t_ops):.4f} ms by "
                f"{'bytes' if t_bytes >= t_ops else 'operations'} (counted, not "
                f"measured: {byts} bytes -> {t_bytes:.4f} ms, {flops} flops -> "
                f"{t_ops:.4f} ms); library call: none ({NO_LIBRARY_CALL[name]})")
        entry["launches_f32"] = solves["float32"]["launches"][name]
        rows.append(entry)
    kn_time = sum(r["ms"] * r["launches"] for r in rows) / max(
        solves["float64"]["iterations"], 1)
    log("solve float64", f"the kernels' device time per iteration {kn_time:.4f} ms "
        f"of the median {solves['float64']['ms_per_iteration_median']:.4f} ms")

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def work(name, args, plan):
    """(bytes, flops) that the function itself needs on these inputs: each
    input read once and each output written once, where the inputs are the
    tensors and the row -> camera / point maps (cam_idx, pt_idx), not the
    design's own plans or workspaces; and the arithmetic, taking each
    symmetric product once."""
    B, P, C = plan.B, plan.P, plan.C
    idx = nbytes(plan.cam_idx, plan.pt_idx)
    if name == "eval_fused":
        cams, pts, obs = args[:3]
        es = cams.element_size()
        byts = nbytes(cams, pts, obs) + idx + es * 26 * B + 8
        return byts, 330 * B  # rotation with its 3 derivatives, projection, J
    if name == "post_eval_fused":
        JT, rT = args[:2]
        es = JT.element_size()
        byts = nbytes(JT, rT) + idx + es * (15 * P + 18 * C)
        # g_e, sqn_e, E'E (6 of 9), g_f, sqn_f per row
        return byts, (12 + 12 + 24 + 36 + 36) * B
    if name == "schur_assembly":
        JT, sc, sp, K, u = args[:5]
        es = JT.element_size()
        byts = nbytes(JT, sc, sp, K, u) + idx + es * ((9 * C) ** 2 + 81 * C + 9 * C)
        NP = plan.pair_a.shape[0]  # ordered pairs of rows of one point, a == b too
        # per row: scaling 24, W 108, Y 162, FtF (45 of 81) 180, U 54;
        # Y_a'Y_b once per unordered pair a != b, 45 of 81 entries for a == b
        return byts, 528 * B + 486 * (NP - B) // 2 + 270 * B
    JT, xc, xp = args[:3]
    es = JT.element_size()
    byts = nbytes(JT, xc, xp) + idx + es * (9 * C + 3 * P)
    return byts, 96 * B  # jv, J_f'jv, J_e'jv per row


if __name__ == "__main__":
    sys.exit(main())
