"""The JAX package's answers on the runs of chip_smoke.py's examples
phase, the goldens (EXAMPLES_GOLDEN) that it holds the port's example
scripts to: each run of chip_smoke.EXAMPLE_RUNS, "script arguments",
through the JAX script of ceres_tpu/examples/ with those arguments on the
CPU, libmv_bundle_adjuster.py on libmv16 written to a file by
chip_smoke.libmv16 and chip_smoke.write_libmv_file (the bytes the phase
writes on the card). Each solve goes through `ceres_tpu.solve` (or
models.mgh's, or the rosenbrock script's `solve_gradient_problem`), which
this script wraps to record the summary; standard input is empty
(circle_fit.py reads points from a pipe).

    JAX_PLATFORMS=cpu python scripts/examples_golden.py [script ...]

runs the runs of the scripts named (all by default) and prints, per run,
one line "run: value" whose value is a Python literal, a list with one
(termination, final cost, summary rows, initial cost) per solve. Takes
about six minutes on a CPU, most of it the four bundle_adjuster.py runs
at BAL-16's shape and ellipse_approximation.py.
"""
import contextlib
import importlib
import io
import sys
import tempfile
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import ceres_tpu  # noqa: E402
import ceres_tpu.models.mgh  # noqa: E402
import chip_smoke  # noqa: E402


def run(key, libmv_file):
    name, *argv = key.split()
    argv = [libmv_file if a == chip_smoke.LIBMV16_FILE else a for a in argv]
    mod = importlib.import_module(f"ceres_tpu.examples.{name}")
    rows = []
    owners = ([(mod, "solve_gradient_problem")] if name == "rosenbrock" else
              [(ceres_tpu, "solve"), (ceres_tpu.models.mgh, "solve")])
    saved = [getattr(o, a) for o, a in owners]
    for (owner, attr), inner in zip(owners, saved):
        def wrapped(*a, _inner=inner, **kw):
            s = _inner(*a, **kw)
            rows.append((str(s.termination_type), float(s.final_cost), len(s.iterations),
                         float(s.initial_cost)))
            return s
        setattr(owner, attr, wrapped)
    old = sys.argv, sys.stdin
    sys.argv, sys.stdin = [name] + argv, io.StringIO("")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            mod.main()
    finally:
        sys.argv, sys.stdin = old
        for (owner, attr), inner in zip(owners, saved):
            setattr(owner, attr, inner)
    return rows


def main():
    only = set(sys.argv[1:])
    with tempfile.TemporaryDirectory() as tmp:
        libmv_file = str(Path(tmp) / "libmv16.bin")
        chip_smoke.write_libmv_file(libmv_file, chip_smoke.libmv16())
        for key in chip_smoke.EXAMPLE_RUNS:
            if only and key.split()[0] not in only:
                continue
            print(f"{key!r}: {run(key, libmv_file)!r},", flush=True)


if __name__ == "__main__":
    main()
