"""The JAX package's answers on the paths of the sparse direct solvers, the
goldens that chip_smoke.py's sparse phase holds the port to
(SPARSE16_GOLDEN), solved on the CPU in the JAX host loop (which both
packages take for every sparse solver):

  (a) BAL-16 (cgnr16_golden.bal16) with SPARSE_SCHUR in float64 and
      float32, default options otherwise;
  (b) BAL-16 with SPARSE_NORMAL_CHOLESKY: default options (float64), and
      the configurations of tests/test_bal_golden.py:71-96 with
      fused_loop="NEVER": mixed-precision solves with 3 refinements, 25
      iterations, and dynamic sparsity, cut to 3 iterations (chip_smoke.py's
      DYNAMIC16_ITERATIONS: it analyzes J'J anew at every step);
  (c) BAL-16 built one block at a time, CGNR with the SUBSET preconditioner
      over every residual block but one observation of each point seen at
      least 6 times (tests/test_bal_golden.py:104-143), eta 1e-2, 35
      iterations;
  (d) pose graphs with the default options (SPARSE_NORMAL_CHOLESKY):
      synthetic_3d with 2,500 poses (sphere2500's count) and 250 loop
      closures, 20 iterations; synthetic_2d with 3,500 poses (M3500's) and
      350 loop closures.

    JAX_PLATFORMS=cpu python scripts/sparse16_golden.py [a b c d]

runs the paths named (all by default). Prints one line per solve: path,
termination, final cost, summary rows, CG iterations. Takes about five
minutes on a CPU.
"""
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import ceres_tpu as ct  # noqa: E402
from ceres_tpu.models import bal, pose_graph  # noqa: E402
from cgnr16_golden import bal16  # noqa: E402

LS = ct.LinearSolverType

# the pose graphs of chip_smoke.py's sparse phase: (poses, loop closures,
# noise, seed, max_num_iterations)
POSE3D = (2500, 250, 0.01, 0, 20)
POSE2D = (3500, 350, 0.02, 0, 50)


def show(path, s):
    print(path, s.termination_type.name, repr(s.final_cost), len(s.iterations),
          [r.linear_solver_iterations for r in s.iterations], flush=True)


def subset_ids(problem, b):
    counts = np.bincount(np.asarray(b.point_index), minlength=b.num_points)
    dropped, keep = set(), []
    for rb, p in zip(problem.residual_blocks(), np.asarray(b.point_index)):
        if counts[p] >= 6 and p not in dropped:
            dropped.add(p)
            continue
        keep.append(rb.rb_id)
    return keep


def run_a():
    for dtype in ("float64", "float32"):
        s = ct.solve(ct.Options(linear_solver_type=LS.SPARSE_SCHUR, evaluation_dtype=dtype),
                     bal.build_problem_batched(bal16())[0])
        show("a bal16_sparse_schur_" + dtype, s)


def run_b():
    for path, kw in (
            ("snc", dict()),
            ("snc_dynamic", dict(dynamic_sparsity=True, fused_loop="NEVER",
                                 max_num_iterations=3)),
            ("snc_mixed", dict(use_mixed_precision_solves=True,
                               max_num_refinement_iterations=3, fused_loop="NEVER",
                               max_num_iterations=25))):
        s = ct.solve(ct.Options(linear_solver_type=LS.SPARSE_NORMAL_CHOLESKY, **kw),
                     bal.build_problem_batched(bal16())[0])
        show("b bal16_" + path, s)


def run_c():
    b = bal16()
    problem = bal.build_problem(b)[0]
    opts = ct.Options(linear_solver_type=LS.CGNR, preconditioner_type=ct.PreconditionerType.SUBSET,
                      residual_blocks_for_subset_preconditioner=subset_ids(problem, b), eta=1e-2,
                      max_num_iterations=35, fused_loop="NEVER")
    show("c bal16_cgnr_subset", ct.solve(opts, problem))


def run_d():
    n, lc, noise, seed, its = POSE3D
    poses, cons, _ = pose_graph.synthetic_3d(num_poses=n, loop_closures=lc, noise=noise, seed=seed)
    s = ct.solve(ct.Options(max_num_iterations=its), pose_graph.build_problem_3d(poses, cons)[0])
    show("d pose3d_2500", s)
    n, lc, noise, seed, its = POSE2D
    poses, cons, _ = pose_graph.synthetic_2d(num_poses=n, loop_closures=lc, noise=noise, seed=seed)
    s = ct.solve(ct.Options(max_num_iterations=its), pose_graph.build_problem_2d(poses, cons)[0])
    show("d pose2d_3500", s)


if __name__ == "__main__":
    for name in sys.argv[1:] or ["a", "b", "c", "d"]:
        {"a": run_a, "b": run_b, "c": run_c, "d": run_d}[name]()
