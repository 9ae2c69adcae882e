"""The JAX package's answer on libmv16, the golden that chip_smoke.py holds
the port's libmv16 solves to: the BAL-16 geometry as a libmv bundle
adjustment problem, built by the recipe of chip_smoke.libmv_instance with
the JAX package's own functions, solved in float64 on the CPU with the
fused loop, DENSE_SCHUR and ITERATIVE_SCHUR + SCHUR_JACOBI.

    JAX_PLATFORMS=cpu python scripts/libmv16_golden.py

Prints one line per solve: termination, final cost, summary rows, CG
iterations. Takes about a minute on a CPU.
"""
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import ceres_tpu as ct  # noqa: E402
from ceres_tpu.models import bal, libmv  # noqa: E402


def libmv16():
    b = bal.synthetic_bal(num_cameras=16, num_points=22106,
                          visibility=83718 / (16 * 22106), noise=1.0, seed=0)
    start = bal.perturb(b, 0.02, 0.2, 0.2, seed=1)
    intr = np.zeros(libmv.INTRINSICS_SIZE)
    intr[0] = b.cameras[:, 6].mean()
    project = jax.vmap(lambda c, p: libmv.libmv_reprojection_residual(
        c, p, jnp.asarray(intr), jnp.zeros(2)))
    markers = np.asarray(project(jnp.asarray(b.cameras[b.camera_index, :6]),
                                 jnp.asarray(b.points[b.point_index])))
    markers = markers + np.random.default_rng(1).standard_normal(markers.shape)
    return libmv.LibmvProblem(
        True, intr, start.cameras[:, :6].copy(), np.arange(16), start.points.copy(),
        np.arange(22106), b.camera_index.astype(np.int64),
        b.point_index.astype(np.int64), markers)


def main():
    for name in ("DENSE_SCHUR", "ITERATIVE_SCHUR"):
        opts = ct.Options(linear_solver_type=ct.LinearSolverType[name],
                          preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
                          fused_loop="ALWAYS")
        s = ct.solve(opts, libmv.build_problem(libmv16())[0])
        print(name, s.termination_type.name, repr(s.final_cost), len(s.iterations),
              [r.linear_solver_iterations for r in s.iterations], flush=True)


if __name__ == "__main__":
    main()
