"""The JAX package's covariance answers that chip_smoke.py's covariance
phase holds the port to, on the CPU: BAL-16 (bal.bal16()) built one block
at a time, camera 0 and point 0 held constant (the gauge) and the 5,134
points fewer than three cameras see (chip_smoke.covariance_gauge),
solved with DENSE_SCHUR, then Covariance over every pair of the 15
variable cameras
(the 135 x 135 camera covariance) by

  qr    SPARSE_QR at the default options (the pure row-Givens QR: 135
        camera columns are under schur_tail_min_cols = 512),
  tail  SPARSE_QR with schur_tail_min_cols=128 (the camera core's R from
        chol(S)),
  ne    SPARSE_QR with use_normal_equations=True.

    JAX_PLATFORMS=cpu python scripts/covariance16_golden.py

Prints the solve's final cost and rows, then per path its diagonal and its
products with COV_PROBES random vectors (default_rng(0), standard
normal): a digest of the matrix small enough to embed. Takes about half
an hour: the JAX QR's minimum-degree ordering of 51k columns one by one.
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
from ceres_tpu.models import bal  # noqa: E402
from cgnr16_golden import bal16  # noqa: E402

import chip_smoke  # noqa: E402

COV_PROBES = 2
PATHS = {"qr": {}, "tail": dict(schur_tail_min_cols=128), "ne": dict(use_normal_equations=True)}


def camera_matrix(cov, cams):
    return np.block([[cov.get_covariance_block(a, b) for b in cams] for a in cams])


def digest(C):
    V = np.random.default_rng(0).standard_normal((C.shape[0], COV_PROBES))
    return [float(v) for v in np.diag(C)], [[float(v) for v in col] for col in (C @ V).T]


def main():
    b = bal16()
    gauge = chip_smoke.covariance_gauge(b)
    p, cams, pts = bal.build_problem(b)
    p.set_parameter_block_constant(cams[0])
    for i in gauge:
        p.set_parameter_block_constant(pts[i])
    s = ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType.DENSE_SCHUR), p)
    print("solve", s.termination_type.name, repr(s.final_cost), len(s.iterations), flush=True)
    var = cams[1:]
    pairs = [(a, b) for a in var for b in var]
    for name, kw in PATHS.items():
        cov = ct.Covariance(ct.CovarianceOptions(**kw))
        ok = cov.compute(pairs, p)
        diag, probes = digest(camera_matrix(cov, var)) if ok else (None, None)
        print(name, ok, "diag", diag, "probes", probes, flush=True)


if __name__ == "__main__":
    main()
