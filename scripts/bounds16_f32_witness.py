"""A witness for where the port's float32 box-bounded BAL-16 stops: the
same solve on the CPU three times, each final cost beside the JAX
package's float32 answer under the same options
(scripts/modeling16_golden.py, path b) and the relative gap:

  default   the default options, as the port runs it (each float32 cost
            summed in float64);
  f32 sums  the default options with every cost summed in float32, as the
            JAX package's probes sum it (program.py's `jnp.sum(cost_b)`
            in the working dtype);
  converged run to convergence (chip_smoke.BOX_F32_TO_CONVERGENCE), the
            solve chip_smoke.py gates.

The box is chip_smoke.py's: per coordinate, the BOX_PERCENTILES of the
perturbed start points; DENSE_SCHUR.

    python scripts/bounds16_f32_witness.py

takes about a minute on a CPU. Nothing of JAX is imported.
"""
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import ceres_tpu_torch as ctt  # noqa: E402
from ceres_tpu_torch.models import bal  # noqa: E402
from ceres_tpu_torch.ops import kernels as kn  # noqa: E402
from ceres_tpu_torch.program import CompiledProgram  # noqa: E402
from chip_smoke import BOX_F32_TO_CONVERGENCE, BOX_PERCENTILES, MODELING16_GOLDEN  # noqa: E402

# scripts/modeling16_golden.py, bounds_dense_float32: the JAX package's
# final cost with the default options (48 rows, 166 coordinates on a bound)
JAX_F32_DEFAULT = 51936.0234375


def solve(b16, lo, hi, **options):
    p, _, pts = bal.build_problem_batched(bal.from_arrays(
        b16.cameras, b16.points, b16.camera_index, b16.point_index, b16.observations))
    p.set_parameter_block_array_bounds(p.parameter_block_arrays()[1], lower=lo, upper=hi)
    s = ctt.solve(ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                              evaluation_dtype="float32", **options), p, device="cpu")
    return s, int(np.sum((pts == lo) | (pts == hi)))


def float32_sums():
    """Patch the two cost sums of a float32 solve to sum in float32: the
    fused evaluation's (eval_fused's plain version on the CPU) and the
    line search's probes (CompiledProgram.evaluate_cost). Returns the undo."""
    plain, probe = kn.eval_fused_plain, CompiledProgram.evaluate_cost

    def eval_fused_plain(cams, pts, obs, plan, rows_fn, loss=None):
        assert not kn._chain(loss).ops  # no robust loss: the cost is sum |r|^2
        cost, rT, JT = plain(cams, pts, obs, plan, rows_fn, loss)
        return torch.sum(rT * rT).to(torch.float64).reshape(1), rT, JT

    def evaluate_cost(self, x):
        _, r = self.evaluate_residuals(x)
        return (0.5 * torch.sum(r * r)).to(torch.float64) + self.fixed_cost

    kn.eval_fused_plain, CompiledProgram.evaluate_cost = eval_fused_plain, evaluate_cost

    def undo():
        kn.eval_fused_plain, CompiledProgram.evaluate_cost = plain, probe
    return undo


def main():
    b16 = bal.bal16()
    lo, hi = (np.percentile(b16.points, q, axis=0) for q in BOX_PERCENTILES)
    converged, _ = MODELING16_GOLDEN["bal16_bounds_dense_f32"]
    runs = (("default", {}, JAX_F32_DEFAULT, False),
            ("f32 sums", {}, JAX_F32_DEFAULT, True),
            ("converged", BOX_F32_TO_CONVERGENCE, converged, False))
    for name, options, golden, patch in runs:
        undo = float32_sums() if patch else (lambda: None)
        try:
            s, on = solve(b16, lo, hi, **options)
        finally:
            undo()
        print(f"{name}: final cost {s.final_cost!r}, {len(s.iterations)} rows, "
              f"{s.termination_type.name}, {on} coordinates on a bound; the JAX "
              f"package's {golden!r}, relative gap {(s.final_cost - golden) / golden:.3e}",
              flush=True)


if __name__ == "__main__":
    main()
