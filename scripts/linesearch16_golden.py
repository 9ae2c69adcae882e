"""The JAX package's answers on the paths of port slice 16, the goldens
that chip_smoke.py's line-search phase holds the port to, solved on the
CPU:

  (a) BAL-16 (cgnr16_golden.bal16), minimizer_type=LINE_SEARCH with
      LBFGS + WOLFE (the Options defaults) in the fused loop (AUTO takes
      it at 168k residuals) and the host loop (fused_loop="NEVER"),
      float64 to LS16_DEPTH["float64"] iterations and float32 to
      LS16_DEPTH["float32"]; nonlinear CG (Fletcher-Reeves) + ARMIJO in
      the fused loop, the same depths. From BAL-16's start (gradient max
      norm 2.3e9) every one of them stops at its first iteration: the
      first step, 1 / 2.3e9, is below min_line_search_step_size and the
      search returns no step. So the same runs again on chip_smoke.py's
      120-camera instance (C120: 120 cameras, 2,000 points, 9,600
      observations), where the line search makes progress;
  (b) BAL-16 DENSE_SCHUR with use_inner_iterations=True: the fused loop in
      float32 for 25 iterations (the tests/test_bal_golden.py config) and
      the host loop in float64 for 25;
  (c) the pose graphs of chip_smoke.py's sparse phase (2,500 poses in 3D,
      3,500 in 2D) with inner iterations in the host loop (the default
      SPARSE_NORMAL_CHOLESKY), INNER_POSE_DEPTH iterations;
  (d) Rosenbrock from (-1.2, 1) with each direction (LBFGS, BFGS, the
      three nonlinear CG betas, steepest descent) and both searches (LBFGS
      and BFGS take WOLFE only) in both loops, 300 iterations; the
      quaternion fit of tests/test_satellite_apis.py:185-207 in both loops.

    JAX_PLATFORMS=cpu python scripts/linesearch16_golden.py [a b c d]

runs the parts named (all by default) and prints, per solve, one line
"key: value" whose value is a Python literal: (termination, final cost,
summary rows' costs) for (a)-(c); for (d) (termination, final cost, the
first ROSEN_ROWS rows' costs, the answer). Takes about ten minutes on a
CPU.
"""
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import ceres_tpu as ct  # noqa: E402
from ceres_tpu import rotation as rot  # noqa: E402
from ceres_tpu.gradient_problem import GradientProblem, solve_gradient_problem  # noqa: E402
from ceres_tpu.models import bal, pose_graph as pg  # noqa: E402
from cgnr16_golden import bal16  # noqa: E402

LS16_DEPTH = {"float64": 50, "float32": 8}
INNER_POSE_DEPTH = 8
POSE3D = (2500, 250, 0.01, 0)
POSE2D = (3500, 350, 0.02, 0)
ROSEN_ROWS = 6
LS = ct.MinimizerType.LINE_SEARCH


def show(key, s, extra=None):
    out = (s.termination_type.name, s.final_cost, [r.cost for r in s.iterations])
    if extra is not None:
        out = out + (extra,)
    print(f"{key!r}: {out!r},", flush=True)


def c120():
    """chip_smoke.py's C120 instance."""
    return bal.perturb(bal.synthetic_bal(num_cameras=120, num_points=2000, visibility=0.04,
                                         seed=6), 0.01, 0.05, 0.05, seed=1)


def run_a():
    for shape, make in (("bal16", bal16), ("c120", c120)):
        for dtn in ("float64", "float32"):
            depth = LS16_DEPTH[dtn]
            for name, loop, kw in (
                    ("lbfgs", "AUTO", {}), ("lbfgs", "NEVER", {}),
                    ("ncg_armijo", "AUTO", dict(
                        line_search_type=ct.LineSearchType.ARMIJO,
                        line_search_direction_type=(
                            ct.LineSearchDirectionType.NONLINEAR_CONJUGATE_GRADIENT)))):
                s = ct.solve(ct.Options(minimizer_type=LS, fused_loop=loop,
                                        evaluation_dtype=dtn, max_num_iterations=depth, **kw),
                             bal.build_problem_batched(make())[0])
                show((shape, name, loop, dtn), s, (s.num_line_search_steps,))


def run_b():
    for loop, dtn in (("ALWAYS", "float32"), ("NEVER", "float64")):
        s = ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
                                use_inner_iterations=True, fused_loop=loop,
                                evaluation_dtype=dtn, max_num_iterations=25),
                     bal.build_problem_batched(bal16())[0])
        show(("inner_dense_schur", loop, dtn), s, (s.num_inner_iteration_steps,))


def run_c():
    import copy

    for name, dims, gen, build in (("pose3d", POSE3D, pg.synthetic_3d, pg.build_problem_3d),
                                   ("pose2d", POSE2D, pg.synthetic_2d, pg.build_problem_2d)):
        n, lc, noise, seed = dims
        poses, cons, _ = gen(num_poses=n, loop_closures=lc, noise=noise, seed=seed)
        s = ct.solve(ct.Options(use_inner_iterations=True, max_num_iterations=INNER_POSE_DEPTH),
                     build(copy.deepcopy(poses), cons)[0])
        show((name, "inner"), s, (s.num_inner_iteration_steps,))


def rosenbrock(x):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] * x[0]) ** 2


ROSEN_CONFIGS = [("LBFGS", "WOLFE", "FLETCHER_REEVES"), ("BFGS", "WOLFE", "FLETCHER_REEVES")] + [
    ("NONLINEAR_CONJUGATE_GRADIENT", s, b) for b in ("FLETCHER_REEVES", "POLAK_RIBIERE",
                                                     "HESTENES_STIEFEL")
    for s in ("WOLFE", "ARMIJO")] + [
    ("STEEPEST_DESCENT", s, "FLETCHER_REEVES") for s in ("WOLFE", "ARMIJO")]


def quaternion_cost(q):
    v = rot.unit_quaternion_rotate_point(q, jnp.asarray([1.0, 0.0, 0.0]))
    return jnp.sum((v - jnp.asarray([0.0, 0.0, 1.0])) ** 2)


def run_d():
    for loop in ("NEVER", "ALWAYS"):
        for d, srch, beta in ROSEN_CONFIGS:
            x = np.asarray([-1.2, 1.0])
            s = solve_gradient_problem(ct.Options(
                minimizer_type=LS, fused_loop=loop, max_num_iterations=300,
                line_search_direction_type=ct.LineSearchDirectionType[d],
                line_search_type=ct.LineSearchType[srch],
                nonlinear_conjugate_gradient_type=ct.NonlinearConjugateGradientType[beta]),
                GradientProblem(rosenbrock, 2), x)
            print(f"{(d, srch, beta, loop)!r}: {(s.termination_type.name, s.final_cost, [r.cost for r in s.iterations[:ROSEN_ROWS]], x.tolist())!r},",
                  flush=True)
        q = np.asarray([1.0, 0.0, 0.0, 0.0])
        s = solve_gradient_problem(
            ct.Options(minimizer_type=LS, fused_loop=loop, max_num_iterations=200),
            GradientProblem(quaternion_cost, 4, manifold=ct.QuaternionManifold()), q)
        print(f"{('quaternion', loop)!r}: {(s.termination_type.name, s.final_cost, [r.cost for r in s.iterations], q.tolist())!r},",
              flush=True)


if __name__ == "__main__":
    parts = sys.argv[1:] or ["a", "b", "c", "d"]
    for p in parts:
        {"a": run_a, "b": run_b, "c": run_c, "d": run_d}[p]()
