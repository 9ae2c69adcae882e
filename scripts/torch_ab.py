"""The port on one card, compared between source trees: the wall per LM
iteration on BAL-16, libmv16 and libmv-Venice, post_eval_fused's kernel
(row 2) at BAL-16 and at the Venice shape, the segment sums (rows 6 and 9)
at the libmv16 and libmv-Venice shapes, and eval_fused (rows 1, 1L, 1Q)
and the spread sum (rows 8J, 8).

    python3 scripts/torch_ab.py [--kernels-only | --eval-spread] TREE [TREE ...]

Each TREE is a checkout of the repo (e.g. the parent commit unpacked with
`git archive` into a git-ignored directory, and the change); give them in
the order parent, change, change, parent, so that drift of the card or the
host shows as a difference between the two runs of one tree. Each tree runs
in its own process with its own `ceres_tpu_torch` first on the path (and
builds its own kernels into its own `build/`). A process prints one JSON
line: the tree, the card's name and power limit, and
- for each BAL-16 configuration, the median and the runs of minimizer ms
  per LM iteration over 5 solves after one that warms up, as
  `chip_smoke.py` measures them;
- for libmv16 DENSE_SCHUR and ITERATIVE_SCHUR in float64 the same, and for
  libmv-Venice ITERATIVE_SCHUR in float32 (5 LM iterations) the median over
  3 solves after one that warms up, with each solve's time to first
  iteration (the preprocessor's seconds: the plans are built there);
- row 2's ms per call in float64 and float32 at BAL-16 and Venice, by
  `chip_smoke.time_cuda` (this script's own copy of `chip_smoke.py`, so
  every tree is timed alike), on random J and r (the kernel's work does not
  depend on their values) over the row plan of the shape's structure;
- rows 6 and 9 the same way at libmv16 and libmv-Venice (`SEGMENT_CASES`:
  each case's ids as the flat path's plans hold them, rows by point,
  random contrib), in both dtypes, with the call's own peak device memory;
- rows 1, 1L and 1Q (eval_fused: angle-axis, angle-axis + HuberLoss(1.0),
  quaternion + HuberLoss(1.0)) at BAL-16 and Venice at the start state, in
  both dtypes; row 8J at the
  specialized pipeline's first-iteration inputs on BAL-16, the whole call
  and its slab pass alone (the same call without Jc, row 8's entry point:
  the F'F passes are the rest); row 8 at libmv16's rows (te = 3, tf = 6,
  the cameras' A) on random Y.
`--kernels-only` skips the walls, `--eval-spread` runs only rows 1, 1L,
1Q, 8J and 8. Needs a card; takes a few minutes per tree on an H100 once
its kernels are built.
"""
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ("bal16_dense_f64", "bal16_dense_f32", "bal16_iterative_f64")
# (case, ids, width): the points' sums (sorted ids, P + 1 keys with the flat
# plans' sentinel) of a CG iteration (3) and of the post-evaluation (15); the
# one intrinsics key's (8, 80); the cameras' (unsorted, C + 1 keys: 6, 48)
SEGMENT_CASES = (("row6_w3", "points", 3), ("row6_w15", "points", 15),
                 ("row6_one_key_w8", "one_key", 8), ("row6_one_key_w80", "one_key", 80),
                 ("row9_w6", "cameras", 6), ("row9_w48", "cameras", 48))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("ab_chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def walls(ctt, bal, cs, out) -> None:
    """The minimizer's ms per LM iteration of each wall configuration."""
    import torch

    from ceres_tpu_torch.models import libmv

    DS, IS = ctt.LinearSolverType.DENSE_SCHUR, ctt.LinearSolverType.ITERATIVE_SCHUR
    options = {
        "bal16_dense_f64": ctt.Options(linear_solver_type=DS),
        "bal16_dense_f32": ctt.Options(linear_solver_type=DS, evaluation_dtype="float32"),
        "bal16_iterative_f64": ctt.Options(linear_solver_type=IS, max_num_iterations=30,
                                           max_linear_solver_iterations=100),
        "libmv16_dense_f64": ctt.Options(linear_solver_type=DS),
        "libmv16_iterative_f64": ctt.Options(linear_solver_type=IS),
        "libmv_venice_iterative_f32": ctt.Options(
            linear_solver_type=IS, evaluation_dtype="float32",
            max_num_iterations=cs.VENICE_LM_ITERATIONS),
    }
    lp16, lpv = cs.libmv16(), None
    for name, opts in options.items():
        if name.startswith("libmv_venice") and lpv is None:
            lpv = cs.libmv_venice()
        problem = {"bal16": lambda: bal.build_problem_batched(bal.bal16())[0],
                   "libmv16": lambda: libmv.build_problem(cs.fresh(lp16))[0],
                   "libmv_venice": lambda: libmv.build_problem(cs.fresh(lpv))[0]}[
            name.rsplit("_", 2)[0]]
        per_it, first = [], []
        for k in range(4 if name.startswith("libmv_venice") else 6):
            s = ctt.solve(opts, problem())
            torch.cuda.synchronize()
            if k:  # the first solve warms up
                per_it.append(1e3 * s.minimizer_time_in_seconds / (len(s.iterations) - 1))
                first.append(s.preprocessor_time_in_seconds)
        out[name] = {"ms_per_iteration_median": statistics.median(per_it),
                     "ms_per_iteration_runs": per_it, "time_to_first_iteration_s": first}


def segment_sums(bal, cs, fo, kn, out) -> None:
    """Rows 6 and 9 at libmv16's and libmv-Venice's ids (SEGMENT_CASES)."""
    import torch

    lp16 = cs.libmv16()
    big = bal.synthetic_bal_large(**cs.VENICE)
    shapes = {"libmv16": (lp16.marker_pt, lp16.marker_cam, lp16.points.shape[0],
                          lp16.cameras.shape[0], 100),
              "libmv_venice": (big.point_index, big.camera_index, big.num_points,
                               big.num_cameras, 20)}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape, (pt, cam, P, C, n) in shapes.items():
        B = pt.shape[0]
        plans = {"points": fo.build_segment_plan(pt, P + 1, "cuda"),
                 "cameras": fo.build_segment_plan(cam, C + 1, "cuda"),
                 "one_key": fo.build_segment_plan(np.zeros(B, np.int64), 2, "cuda")}
        for dt in (torch.float64, torch.float32):
            for case, ids, w in SEGMENT_CASES:
                plan = plans[ids]
                fn = kn.unsorted_segment_sum if ids == "cameras" else kn.segment_block_sum
                x = torch.randn((B, w), generator=gen, device="cuda", dtype=dt)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                fn(x, plan)
                torch.cuda.synchronize()
                key = f"{shape}_{case}_{cs.TAG[str(dt)[6:]]}"
                out[key + "_peak_mib"] = (torch.cuda.max_memory_allocated() - held) / 2**20
                out[key + "_ms"] = cs.time_cuda(lambda: fn(x, plan), n)
                del x


def eval_spread(ctt, bal, cs, kn, out) -> None:
    """Rows 1, 1L, 1Q, 8J and 8 (see the module's docstring)."""
    import torch

    from ceres_tpu_torch.parallel import sharded_ba as sb
    from ceres_tpu_torch.program import CompiledProgram

    def put(key, fn, n):
        torch.cuda.synchronize()
        out[key] = cs.time_cuda(fn, n)

    b16 = bal.bal16()
    venice = bal.perturb(bal.synthetic_bal_large(**cs.VENICE), **cs.VENICE_PERTURB)
    for shape, b, n in (("bal16", b16, 100), ("venice", venice, 20)):
        # float64 programs; their float32 arguments are the same tables cast
        progs = {m: CompiledProgram(cs.robust_problem(bal, b, m, ctt.HuberLoss(1.0)),
                                    "float64", device="cuda")
                 for m in ("angle_axis", "quat")}
        huber = {m: cs.eval_args(p) for m, p in progs.items()}
        del progs
        for dt in (torch.float64, torch.float32):
            tag = cs.TAG[str(dt)[6:]]
            cast = {m: tuple(a.to(dt) if torch.is_tensor(a) and a.is_floating_point()
                             else a for a in args) for m, args in huber.items()}
            cases = {"row1": cast["angle_axis"][:5] + (None,),
                     "row1L": cast["angle_axis"], "row1Q": cast["quat"]}
            for row, args in cases.items():
                put(f"{row}_{shape}_{tag}_ms", lambda: kn.eval_fused(*args), n)
            del cast, cases
        del huber
    del venice
    for dt in (torch.float64, torch.float32):
        tag = cs.TAG[str(dt)[6:]]
        ci, pi, obs = sb.observations_by_point(b16.camera_index, b16.point_index,
                                               b16.observations, dt, "cuda")
        plan = sb.build_point_plan(ci, pi, b16.num_points, b16.num_cameras, "cuda")
        st = sb.state_from_arrays(b16.cameras, b16.points, 1e4, dt, "cuda")
        args = cs.first_iteration_args(
            "v1", lambda s, k: sb.lm_step_schur_k(s.cams, s.pts, ci, pi, obs, s.radius,
                                                  k=k, plan=plan), st)["segment_spread_ftf"]
        put(f"row8J_spec_{tag}_ms", lambda: kn.segment_spread_sum(*args), 100)
        put(f"row8J_spec_{tag}_slab_ms", lambda: kn.segment_spread_sum(*args[:6]), 100)
        out[f"row8J_spec_{tag}_ftf_ms"] = (out[f"row8J_spec_{tag}_ms"]
                                           - out[f"row8J_spec_{tag}_slab_ms"])
        del args, plan
    lp = cs.libmv16()
    counts = np.bincount(lp.marker_pt, minlength=lp.points.shape[0])
    pt_start = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
                               device="cuda")
    cam = torch.as_tensor(lp.marker_cam.astype(np.int32), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dt in (torch.float64, torch.float32):
        Y = torch.randn((cam.shape[0], 18), generator=gen, device="cuda", dtype=dt)
        put(f"row8_libmv16_{cs.TAG[str(dt)[6:]]}_ms",
            lambda: kn.segment_spread_sum(Y, cam, pt_start, lp.cameras.shape[0], 3, 6), 100)


def child(tree: Path, kernels_only: bool, only_eval_spread: bool) -> None:
    sys.path.insert(0, str(tree))
    import torch

    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.models import bal
    from ceres_tpu_torch.ops import flatops as fo
    from ceres_tpu_torch.ops import kernels as kn

    assert Path(ctt.__file__).resolve().is_relative_to(tree), ctt.__file__
    cs = _chip_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    out = {"tree": str(tree), "card": card}
    if only_eval_spread:
        eval_spread(ctt, bal, cs, kn, out)
        print(json.dumps(out), flush=True)
        return
    if not kernels_only:
        walls(ctt, bal, cs, out)
    for shape, b, n in (("bal16", bal.bal16(), 100),
                        ("venice", bal.synthetic_bal_large(**cs.VENICE), 20)):
        order = np.argsort(b.point_index, kind="stable")
        plan = fo.build_row_plan(b.point_index[order], b.camera_index[order],
                                 b.num_points, b.num_cameras, "cuda",
                                 n_cams=b.num_cameras)
        gen = torch.Generator(device="cuda").manual_seed(0)
        for dt in (torch.float64, torch.float32):
            JT = torch.randn((kn.LANES, plan.B), generator=gen, device="cuda", dtype=dt)
            rT = torch.randn((kn.R, plan.B), generator=gen, device="cuda", dtype=dt)
            ms = cs.time_cuda(lambda: kn.post_eval_fused(JT, rT, plan), n)
            out[f"post_eval_fused_{shape}_{cs.TAG[str(dt)[6:]]}_ms"] = ms
        del plan, b
    segment_sums(bal, cs, fo, kn, out)
    eval_spread(ctt, bal, cs, kn, out)
    print(json.dumps(out), flush=True)


def main(trees, flags) -> int:
    for t in trees:
        tree = Path(t).resolve()
        if not (tree / "ceres_tpu_torch").is_dir():
            print(f"{tree} holds no ceres_tpu_torch", file=sys.stderr)
            return 2
        env = dict(os.environ, PYTHONPATH=str(tree))
        rc = subprocess.run([sys.executable, __file__, "--child", str(tree), *flags],
                            env=env, cwd=tree).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    flags = [a for a in args if a in ("--kernels-only", "--eval-spread")]
    args = [a for a in args if a not in flags]
    if len(args) == 2 and args[0] == "--child":
        child(Path(args[1]), "--kernels-only" in flags, "--eval-spread" in flags)
    elif args:
        sys.exit(main(args, flags))
    else:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
