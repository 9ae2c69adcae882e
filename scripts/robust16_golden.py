"""The JAX package's answers on BAL-16 with a robust loss, the goldens that
chip_smoke.py holds the port's robust solves to: the problem of
bench.py:119 (`_bal16`: 16 cameras, 22,106 points, 84,218 observations)
with HuberLoss(1.0) on every observation (bundle_adjuster.cc --robustify),
once with angle-axis cameras (`build_problem_batched(..., use_huber=True)`)
and once with quaternion cameras under ProductManifold(QuaternionManifold,
EuclideanManifold(6)) (`build_problem_batched_quat`; --use_quaternions
--use_manifolds). Solved in float64 on the CPU with the fused loop,
DENSE_SCHUR with the default options and ITERATIVE_SCHUR + SCHUR_JACOBI
with max_num_iterations=30, max_linear_solver_iterations=100 (the options
of chip_smoke.py's BAL-16 iterative solves).

    JAX_PLATFORMS=cpu python scripts/robust16_golden.py

Prints one line per solve: configuration, termination, final cost, summary
rows, CG iterations. Takes a few minutes on a CPU.
"""
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import ceres_tpu as ct  # noqa: E402
from ceres_tpu.models import bal  # noqa: E402


def bal16():
    n_cams, n_pts = 16, 22106
    b = bal.synthetic_bal(num_cameras=n_cams, num_points=n_pts,
                          visibility=83718 / (n_cams * n_pts), noise=1.0, seed=0)
    return bal.perturb(b, rotation_sigma=0.02, translation_sigma=0.2,
                       point_sigma=0.2, seed=1)


PROBLEMS = {
    "bal16_huber": lambda: bal.build_problem_batched(bal16(), use_huber=True)[0],
    "bal16_quat_huber": lambda: bal.build_problem_batched_quat(
        bal16(), ct.HuberLoss(1.0))[0],
}


def main():
    for name, make in PROBLEMS.items():
        for solver in ("DENSE_SCHUR", "ITERATIVE_SCHUR"):
            extra = ({} if solver == "DENSE_SCHUR" else
                     dict(max_num_iterations=30, max_linear_solver_iterations=100))
            opts = ct.Options(linear_solver_type=ct.LinearSolverType[solver],
                              preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
                              fused_loop="ALWAYS", **extra)
            s = ct.solve(opts, make())
            print(name, solver, s.termination_type.name, repr(s.final_cost),
                  len(s.iterations), [r.linear_solver_iterations for r in s.iterations],
                  flush=True)


if __name__ == "__main__":
    main()
