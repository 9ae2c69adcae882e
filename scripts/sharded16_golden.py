"""The JAX package's multi-device tiers on BAL-16, the goldens that
chip_smoke.py's mesh phase holds the port's tiers to (MESH16_GOLDEN):
each tier of ceres_tpu/parallel (and fused_lm.solve_sharded_fused) on the
CPU's 8-device mesh, float64, on the problem of bench.py:119 (16 cameras,
22,106 points, 84,218 observations), with the CG budget pinned where the
step's CG stops adaptively (eta = 1e-30, 8 iterations), as
tests/test_sharding.py:441-447 pins it.

    JAX_PLATFORMS=cpu python scripts/sharded16_golden.py [case ...]

Prints one line per case: its name, then a JSON object with the final
cost and the state's digest (chip_smoke.mesh_digest: each table's column
sums of squares, the first two cameras, eight points spread over the
table; for the evaluator the gradient's instead). The cases and their
arguments are chip_smoke.MESH16_CASES'.
"""
import json
import os
import sys
import time
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import ceres_tpu as ct  # noqa: E402
from ceres_tpu.models import bal  # noqa: E402
from ceres_tpu.parallel import sharded_ba as sb  # noqa: E402
from ceres_tpu.parallel import sharded_program as sp  # noqa: E402
from ceres_tpu.parallel.mesh import make_mesh, solve_sharded  # noqa: E402
from ceres_tpu.program import CompiledProgram  # noqa: E402
from ceres_tpu.solvers.fused_lm import solve_sharded_fused  # noqa: E402

PIN = dict(eta=1e-30, max_linear_solver_iterations=8)


def bal16():
    n_cams, n_pts = 16, 22106
    b = bal.synthetic_bal(num_cameras=n_cams, num_points=n_pts,
                          visibility=83718 / (n_cams * n_pts), noise=1.0, seed=0)
    return bal.perturb(b, rotation_sigma=0.02, translation_sigma=0.2,
                       point_sigma=0.2, seed=1)


def digest(cams, pts):
    """chip_smoke.mesh_digest."""
    cams, pts = np.asarray(cams, np.float64), np.asarray(pts, np.float64)
    idx = np.linspace(0, pts.shape[0] - 1, 8).astype(np.int64)
    return {"cams_sq": np.sum(cams * cams, axis=0).tolist(),
            "cams_first": cams[:2].reshape(-1).tolist(),
            "pts_sq": np.sum(pts * pts, axis=0).tolist(),
            "pts_sample": pts[idx].reshape(-1).tolist()}


def copy_of(b):
    return bal.BALProblem(b.cameras.copy(), b.points.copy(), b.camera_index.copy(),
                          b.point_index.copy(), b.observations.copy())


def run(name, b):
    mesh = make_mesh(8)
    if name == "evaluator":
        prog = CompiledProgram(bal.build_problem_batched(copy_of(b))[0])
        cost, _, g = prog.evaluate_grad(prog.initial_state())
        g = np.asarray(g)
        return {"cost": float(cost), "g_sq": float(np.sum(g * g)), "g_first": g[:18].tolist()}
    if name in ("solve_sharded", "solve_sharded_fused"):
        problem, cams, pts = bal.build_problem_batched(copy_of(b))
        fn = solve_sharded if name == "solve_sharded" else solve_sharded_fused
        s = fn(ct.Options(linear_solver_type=ct.LinearSolverType.CGNR, max_num_iterations=4,
                          **PIN), problem, mesh)
        return {"cost": s.final_cost, "rows": len(s.iterations), **digest(cams, pts)}
    if name in ("solve_ba_cg", "solve_ba_schur"):
        step = name.split("_")[-1]
        st = sb.solve_ba(copy_of(b), num_iterations=2 if step == "cg" else 4,
                         mesh=sb.make_mesh(8), cg_iters=8, step=step)
        return {"cost": float(st.cost), **digest(st.cams, st.pts)}
    if name == "point":
        st, plan = sb.solve_ba_point_sharded(copy_of(b), num_iterations=4,
                                             mesh=sb.make_mesh(8, axis="pt"), k=4)
        return {"cost": float(st.cost),
                **digest(st.cams, np.asarray(st.pts)[plan.point_slot])}
    if name in ("camera", "halo"):
        st, plan = sb.solve_ba_camera_sharded(copy_of(b), num_iterations=2,
                                              mesh=sb.make_mesh(8, axis="cam"), k=1,
                                              cg_iters=8, halo=name == "halo")
    elif name == "halo_ceres":
        st, plan, term = sb.solve_ba_camera_halo_ceres(
            copy_of(b), sb.ShardedLMOptions(**PIN), mesh=sb.make_mesh(8, axis="cam"), k=4,
            max_num_iterations=4)
    else:  # program_halo, program_halo_quat
        build = (bal.build_problem_batched_quat if name.endswith("quat")
                 else bal.build_problem_batched)
        prog = CompiledProgram(build(copy_of(b))[0])
        x, info, _ = sp.solve_program_camera_halo(
            prog, sb.ShardedLMOptions(**PIN), max_num_iterations=3,
            mesh=sb.make_mesh(8, axis="cam"), k=2)
        tables = [np.asarray(x)[f.state_offset:f.state_offset + f.count * f.asize].reshape(
            f.count, f.asize) for f in (s.family for s in prog.kinds[0].slots)]
        return {"cost": info["final_cost"], **digest(*tables)}
    return {"cost": float(st.cost), **digest(np.asarray(st.cams)[plan.camera_slot],
                                             np.asarray(st.pts)[plan.point_slot])}


CASES = ("evaluator", "solve_sharded", "solve_sharded_fused", "solve_ba_cg",
         "solve_ba_schur", "point", "camera", "halo", "halo_ceres", "program_halo",
         "program_halo_quat")


def main(argv):
    b = bal16()
    for name in argv or CASES:
        t0 = time.monotonic()
        out = run(name, b)
        print(name, json.dumps(out), f"# {time.monotonic() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
