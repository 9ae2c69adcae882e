"""The JAX package's TinySolver answers that chip_smoke.py's TinySolver
phase holds the port to, on the CPU: `solve_batch` on the first
TINY_GOLDEN_LANES of chip_smoke.triangulations(TINY_LANES, seed=0) (the
lanes are independent, so these are the first lanes of the card's run),
and `solve` on Rosenbrock from (-1.2, 1) as tests/test_satellite_apis.py's
test_tiny_solver_single.

    JAX_PLATFORMS=cpu python scripts/tiny_solver_golden.py

Prints, for the batch, each lane's iterations (int8), its x's distance
from its truth in units of TINY_X_QUANTUM (int32) and its final cost in
units of TINY_COST_QUANTUM of its initial cost (int32), rounded, as
zlib-compressed base64 (chip_smoke.unpack_ints reads them back); then
Rosenbrock's x, final cost and iterations. Takes under a minute.
"""
import base64
import sys
import zlib
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import ceres_tpu as ct  # noqa: E402
from ceres_tpu import rotation as rot  # noqa: E402

import chip_smoke  # noqa: E402


def pack(a, dtype) -> str:
    a = np.asarray(a)
    assert np.abs(a).max() < np.iinfo(dtype).max
    return base64.b64encode(zlib.compress(a.astype(dtype).tobytes(), 9)).decode()


def main():
    n = chip_smoke.TINY_GOLDEN_LANES
    X, x0, cams, obs = (a[:n] for a in chip_smoke.triangulations(chip_smoke.TINY_LANES))
    ts = ct.TinySolver(chip_smoke.triangulation_residual(rot))
    x, s = ts.solve_batch(jnp.asarray(x0), (jnp.asarray(cams), jnp.asarray(obs)))
    x = np.asarray(x)
    print("iterations", pack(np.asarray(s.iterations), np.int8))
    print("x_minus_truth", pack(np.round((x - X) / chip_smoke.TINY_X_QUANTUM), np.int32))
    print("cost_of_initial", pack(np.round(np.asarray(s.final_cost) / np.asarray(s.initial_cost)
                                           / chip_smoke.TINY_COST_QUANTUM), np.int32))
    print("max |x - truth|", float(np.abs(x - X).max()), "iterations max",
          int(np.max(s.iterations)))

    def rosenbrock(x, data):
        return jnp.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])

    xr, sr = ct.TinySolver(rosenbrock).solve(jnp.asarray([-1.2, 1.0]))
    print("rosenbrock", [float(v) for v in xr], repr(float(sr.final_cost)),
          int(sr.iterations))


if __name__ == "__main__":
    main()
