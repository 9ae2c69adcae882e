"""The JAX package's answers on the paths of the modeling API, the goldens
that chip_smoke.py's modeling phase holds the port to, solved on the CPU
with the fused loop (fused_loop="ALWAYS": the port always runs it):

  (a) gauge-fixed BAL-16: built one block at a time (bal.build_problem,
      84,218 residual blocks), the first camera held constant;
      DENSE_SCHUR and ITERATIVE_SCHUR + SCHUR_JACOBI, float64 and float32;
  (b) box-bounded BAL-16: the batched build with a box on the points, per
      coordinate the BOX_PERCENTILES of the perturbed start points (the
      2nd to 98th left 0.09% of the answer's coordinates on a bound, under
      1%, so the box is the 5th to 95th); DENSE_SCHUR in float64 and
      float32, and float32 run to convergence (BOX_F32_TO_CONVERGENCE,
      the one chip_smoke.py gates), with the share of start coordinates the
      box clips and of answer coordinates on a bound;
  (c) BAL-16 with evaluation_dtype="mixed", DENSE_SCHUR and
      ITERATIVE_SCHUR + SCHUR_JACOBI;
  (d) BAL-16 with use_mixed_precision_solves, DENSE_SCHUR, float64;
  (e) libmv16 (scripts/libmv16_golden.py) with refine_intrinsics=False,
      DENSE_SCHUR and ITERATIVE_SCHUR + SCHUR_JACOBI, float64;
  (f) BAL-16 DENSE_SCHUR with linear_solver_ordering [[points], [cameras]];
  (g) the 9 constrained More-Garbow-Hillstrom problems with DENSE_QR,
      DENSE_NORMAL_CHOLESKY and DENSE_NORMAL_CHOLESKY with mixed solves.

    JAX_PLATFORMS=cpu python scripts/modeling16_golden.py [a b c d e f g]

runs the paths named (all by default). Prints one line per solve: path,
termination, final cost, summary rows, CG iterations (with the mixed
schedule, the message naming each phase's rows; with bounds, the clipped
and on-bound shares and counts). Takes about ten minutes on a CPU.
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
from ceres_tpu.models import bal, libmv, mgh  # noqa: E402
from cgnr16_golden import bal16  # noqa: E402
from libmv16_golden import libmv16  # noqa: E402

DS, IS = ct.LinearSolverType.DENSE_SCHUR, ct.LinearSolverType.ITERATIVE_SCHUR
BOX_PERCENTILES = (5.0, 95.0)
# the float32 box-bounded solve runs to convergence: with the default
# options it stops on the function tolerance while still falling by ~1e-6
# of its cost a row, at a place that follows float32 rounding
# (scripts/bounds16_f32_witness.py)
BOX_F32_TO_CONVERGENCE = dict(function_tolerance=1e-12, max_num_iterations=200)


def options(lst, **kw):
    return ct.Options(linear_solver_type=lst,
                      preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
                      fused_loop="ALWAYS", **kw)


def report(path, s, extra=""):
    print(path, s.termination_type.name, repr(s.final_cost), len(s.iterations),
          [r.linear_solver_iterations for r in s.iterations], extra, flush=True)


def point_box(b):
    return tuple(np.percentile(b.points, q, axis=0) for q in BOX_PERCENTILES)


def main(paths):
    for lst, name in ((DS, "dense"), (IS, "iterative")) if "a" in paths else ():
        for dtype in ("float64", "float32"):
            p, cams, _ = bal.build_problem(bal16())
            p.set_parameter_block_constant(cams[0])
            report(f"gauge_{name}_{dtype}", ct.solve(options(lst, evaluation_dtype=dtype), p))

    start = bal16()
    lo, hi = point_box(start)
    clipped = np.mean((start.points < lo) | (start.points > hi))
    bounded = (("float64", ""), ("float32", ""), ("float32", "_converged"))
    for dtype, tag in bounded if "b" in paths else ():
        p, _, pts = bal.build_problem_batched(bal16())
        p.set_parameter_block_array_bounds(p.parameter_block_arrays()[1], lower=lo, upper=hi)
        s = ct.solve(options(DS, evaluation_dtype=dtype,
                             **(BOX_F32_TO_CONVERGENCE if tag else {})), p)
        on = (pts == lo) | (pts == hi)
        report(f"bounds_dense_{dtype}{tag}", s,
               f"clipped_at_start {clipped!r} on_bound_share {on.mean()!r} "
               f"on_bound_count {int(on.sum())} inside "
               f"{bool(np.all((pts >= lo) & (pts <= hi)))}")

    for lst, name in ((DS, "dense"), (IS, "iterative")) if "c" in paths else ():
        s = ct.solve(options(lst, evaluation_dtype="mixed"), bal.build_problem_batched(bal16())[0])
        report(f"mixed_{name}", s, repr(s.message))

    if "d" in paths:
        s = ct.solve(options(DS, use_mixed_precision_solves=True),
                     bal.build_problem_batched(bal16())[0])
        report("mixed_solves_dense_float64", s)

    for lst, name in ((DS, "dense"), (IS, "iterative")) if "e" in paths else ():
        s = ct.solve(options(lst), libmv.build_problem(libmv16(), refine_intrinsics=False)[0])
        report(f"libmv16_const_intrinsics_{name}_float64", s)

    if "f" in paths:
        p = bal.build_problem_batched(bal16())[0]
        arrays = p.parameter_block_arrays()
        report("ordering_dense_float64",
               ct.solve(options(DS, linear_solver_ordering=[[arrays[1]], [arrays[0]]]), p))

    for config, over in (("DENSE_QR", {}), ("DENSE_NORMAL_CHOLESKY", {}),
                         ("DENSE_NORMAL_CHOLESKY_mixed", {"use_mixed_precision_solves": True})
                         ) if "g" in paths else ():
        achieved = {}
        for prob in mgh.PROBLEMS:
            if prob.constrained_optimal_cost is None:
                continue
            ok, a, s = mgh.solve_problem(prob, True, options_overrides=dict(
                over, linear_solver_type=ct.LinearSolverType[config.split("_mixed")[0]],
                fused_loop="ALWAYS"))
            achieved[prob.number] = (ok, a)
        print("mgh_constrained", config, achieved, flush=True)


if __name__ == "__main__":
    main(set(sys.argv[1:]) or set("abcdefg"))
