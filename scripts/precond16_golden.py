"""The JAX package's answers on the paths of the preconditioners and Schur
options of ITERATIVE_SCHUR, the goldens that chip_smoke.py's precond phase
holds the port to (PRECOND16_GOLDEN): BAL-16 (cgnr16_golden.bal16), solved
on the CPU in the JAX fused loop (fused_loop="ALWAYS") and in its host loop
("NEVER"), in float64 and float32, with default options otherwise:

  spse       preconditioner SCHUR_POWER_SERIES_EXPANSION
  spse_init  SCHUR_JACOBI with use_spse_initialization
  cj_cv      CLUSTER_JACOBI, visibility_clustering_type CANONICAL_VIEWS
  cj_sl      CLUSTER_JACOBI, SINGLE_LINKAGE
  ct         CLUSTER_TRIDIAGONAL (CANONICAL_VIEWS)
  explicit   use_explicit_schur_complement (JACOBI, which runs as SCHUR_JACOBI)

    JAX_PLATFORMS=cpu python scripts/precond16_golden.py [path ...]

runs the paths named (all by default). Prints one line per solve: path,
loop, dtype, termination, final cost, summary rows, CG iterations; a
solve the JAX package cannot run prints its error instead (its host loop's
explicit S in float32 mixes a float64 S into a float32 CG loop, which
lax.while_loop refuses). Takes about ten minutes on a CPU.
"""
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import ceres_tpu as ct  # noqa: E402
from ceres_tpu.models import bal  # noqa: E402
from ceres_tpu.types import VisibilityClusteringType  # noqa: E402
from cgnr16_golden import bal16  # noqa: E402

PT = ct.PreconditionerType
PATHS = {
    "spse": dict(preconditioner_type=PT.SCHUR_POWER_SERIES_EXPANSION),
    "spse_init": dict(preconditioner_type=PT.SCHUR_JACOBI, use_spse_initialization=True),
    "cj_cv": dict(preconditioner_type=PT.CLUSTER_JACOBI),
    "cj_sl": dict(preconditioner_type=PT.CLUSTER_JACOBI,
                  visibility_clustering_type=VisibilityClusteringType.SINGLE_LINKAGE),
    "ct": dict(preconditioner_type=PT.CLUSTER_TRIDIAGONAL),
    "explicit": dict(use_explicit_schur_complement=True),
}


def main():
    for path in sys.argv[1:] or list(PATHS):
        for loop in ("ALWAYS", "NEVER"):
            for dtype in ("float64", "float32"):
                opts = ct.Options(linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
                                  evaluation_dtype=dtype, fused_loop=loop, **PATHS[path])
                try:
                    s = ct.solve(opts, bal.build_problem_batched(bal16())[0])
                except Exception as e:  # noqa: BLE001 (recorded, not raised)
                    print(path, loop, dtype, "ERROR", type(e).__name__, flush=True)
                    continue
                print(path, loop, dtype, s.termination_type.name, repr(s.final_cost),
                      len(s.iterations), [r.linear_solver_iterations for r in s.iterations],
                      flush=True)


if __name__ == "__main__":
    main()
