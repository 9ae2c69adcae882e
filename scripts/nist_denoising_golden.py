"""The JAX package's NIST and denoising answers that chip_smoke.py's
NIST and denoising phase holds the port to, on the CPU:

  nist       models/nist.run_suite over chip_smoke.NIST_SHAPES written by
             chip_smoke.write_nist_file (seed 0) to a temporary directory:
             the five problems of tests/test_nist.py's fast subset, two
             starts each, default_options();
  denoising  models/denoising on chip_smoke.noisy_image(DENOISE_SIZE) and
             the FoE model of chip_smoke.write_foe_file, sigma 20, CGNR
             for DENOISE_ITERATIONS iterations (examples/denoising.py).

    JAX_PLATFORMS=cpu python scripts/nist_denoising_golden.py [nist denoising]

Prints, per NIST start, its file, final cost, rows and LRE; for
denoising the cost of every summary row and its CG iterations. Takes
about a minute.
"""
import sys
import tempfile
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import ceres_tpu as ct  # noqa: E402
from ceres_tpu.models import denoising, nist  # noqa: E402

import chip_smoke  # noqa: E402


def main(parts):
    with tempfile.TemporaryDirectory() as tmp:
        if "nist" in parts:
            for name in chip_smoke.NIST_SHAPES:
                chip_smoke.write_nist_file(Path(tmp) / f"{name}.dat", name)
                model, n = next((m, k) for f, m, k, _ in nist.SUITE if f == f"{name}.dat")
                for lre, ok, s in nist.run_problem(tmp, f"{name}.dat", model, n):
                    print("nist", name, repr(s.final_cost), len(s.iterations),
                          round(float(lre), 2), flush=True)
        if "denoising" in parts:
            foe_path = Path(tmp) / "model.foe"
            chip_smoke.write_foe_file(foe_path)
            foe = denoising.read_foe_file(foe_path)
            image = chip_smoke.noisy_image(chip_smoke.DENOISE_SIZE)
            problem, _ = denoising.create_problem(foe, image, 20.0)
            s = ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType.CGNR,
                                    max_num_iterations=chip_smoke.DENOISE_ITERATIONS),
                         problem)
            print("denoising", s.termination_type.name,
                  [repr(r.cost) for r in s.iterations],
                  [r.linear_solver_iterations for r in s.iterations], flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["nist", "denoising"])
