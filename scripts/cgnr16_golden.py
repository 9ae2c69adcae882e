"""The JAX package's CGNR answers on BAL-16, the goldens that chip_smoke.py
holds the port's BAL-16 CGNR solves to: the problem of bench.py:119
(`_bal16`: 16 cameras, 22,106 points, 84,218 observations), CGNR with the
JACOBI preconditioner and the default options otherwise (it converges in
about 27 summary rows), in float64 and float32 on the CPU with the fused
loop.

    JAX_PLATFORMS=cpu python scripts/cgnr16_golden.py

Prints one line per solve: dtype, termination, final cost, summary rows,
CG iterations. Takes about a minute on a CPU.
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


def main():
    for dtype in ("float64", "float32"):
        opts = ct.Options(linear_solver_type=ct.LinearSolverType.CGNR,
                          preconditioner_type=ct.PreconditionerType.JACOBI,
                          evaluation_dtype=dtype, fused_loop="ALWAYS")
        s = ct.solve(opts, bal.build_problem_batched(bal16())[0])
        print("bal16_cgnr", dtype, s.termination_type.name, repr(s.final_cost),
              len(s.iterations), [r.linear_solver_iterations for r in s.iterations],
              flush=True)


if __name__ == "__main__":
    main()
