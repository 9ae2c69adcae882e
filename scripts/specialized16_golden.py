"""The JAX package's specialized pipeline on BAL-16, the golden that
chip_smoke.py holds the port's `lm_step_schur_k` and `lm_step_schur_v2_k`
to: `ceres_tpu.parallel.sharded_ba.lm_step_schur_k` on the CPU, on the
problem of bench.py:119 (`_bal16`: 16 cameras, 22,106 points, 84,218
observations) with the rows stably sorted by point, start radius 1e4, four
calls of k = 5 LM iterations each, the XLA path (no pallas_plan). Three
runs: float64, float32 with the module's default flags, and float32 with
PRECISE_SCHUR_SOLVE = True.

    JAX_PLATFORMS=cpu python scripts/specialized16_golden.py

Prints the start cost and the cost and radius after 5, 10, 15 and 20
iterations of each run. Takes about half a minute on a CPU.
"""
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ceres_tpu.models import bal  # noqa: E402
from ceres_tpu.parallel import sharded_ba  # noqa: E402


def bal16():
    n_cams, n_pts = 16, 22106
    b = bal.synthetic_bal(num_cameras=n_cams, num_points=n_pts,
                          visibility=83718 / (n_cams * n_pts), noise=1.0, seed=0)
    return bal.perturb(b, rotation_sigma=0.02, translation_sigma=0.2,
                       point_sigma=0.2, seed=1)


def run(b, dtype, precise_schur):
    sharded_ba.PRECISE_SCHUR_SOLVE = precise_schur
    order = np.argsort(np.asarray(b.point_index), kind="stable")
    ci = jnp.asarray(np.asarray(b.camera_index)[order])
    pi = jnp.asarray(np.asarray(b.point_index)[order])
    obs = jnp.asarray(np.asarray(b.observations)[order], dtype)
    cams = jnp.asarray(b.cameras, dtype)
    pts = jnp.asarray(b.points, dtype)
    radius = jnp.asarray(1e4, dtype)
    start = float(sharded_ba.ba_cost(cams, pts, ci, pi, obs))
    step = jax.jit(lambda c, p, r: sharded_ba.lm_step_schur_k(c, p, ci, pi, obs, r, k=5))
    rows = []
    for _ in range(4):
        st = step(cams, pts, radius)
        cams, pts, radius = st.cams, st.pts, st.radius
        rows.append((float(st.cost), float(st.radius)))
    return start, rows


def main():
    b = bal16()
    print(f"BAL-16: {b.num_cameras} cameras, {b.num_points} points, "
          f"{b.num_observations} observations", flush=True)
    for name, dtype, precise in (("float64", jnp.float64, False),
                                 ("float32", jnp.float32, False),
                                 ("float32 PRECISE_SCHUR_SOLVE", jnp.float32, True)):
        start, rows = run(b, dtype, precise)
        print(name, "start", repr(start), "costs after 5/10/15/20",
              [repr(c) for c, _ in rows], "radii", [repr(r) for _, r in rows],
              flush=True)


if __name__ == "__main__":
    main()
