"""The JAX package's DOGLEG answers on BAL-16, the goldens that
chip_smoke.py holds the port's BAL-16 dogleg solves to: the problem of
bench.py:119 (`_bal16`: 16 cameras, 22,106 points, 84,218 observations),
DENSE_SCHUR with trust_region_strategy_type=DOGLEG (bundle_adjuster.cc
--trust_region_strategy=dogleg), TRADITIONAL_DOGLEG and SUBSPACE_DOGLEG
(--dogleg), the default options otherwise, in float64 on the CPU with the
fused loop.

    JAX_PLATFORMS=cpu python scripts/dogleg16_golden.py

Prints one line per solve: dogleg type, termination, final cost, summary
rows. Takes a few minutes on a CPU.
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
    for dogleg in ("TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG"):
        opts = ct.Options(linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
                          trust_region_strategy_type=ct.TrustRegionStrategyType.DOGLEG,
                          dogleg_type=ct.DoglegType[dogleg], fused_loop="ALWAYS")
        s = ct.solve(opts, bal.build_problem_batched(bal16())[0])
        print("bal16_dogleg", dogleg, s.termination_type.name, repr(s.final_cost),
              len(s.iterations), flush=True)


if __name__ == "__main__":
    main()
