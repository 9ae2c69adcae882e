"""The libmv (Blender tracking) bundle adjuster on its problem files (the
reference's examples/libmv_bundle_adjuster.cc). The default input is the
first problem of the reference's data directory, named relative to it."""
import argparse

import numpy as np

import ceres_tpu_torch as ct
from ceres_tpu_torch.models import libmv


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "input", nargs="?",
        default="data/libmv-ba-problems/problem_01.bin",
    )
    ap.add_argument("--refine_intrinsics", type=int, default=None,
                    help="override: 1 refine shared intrinsics, 0 hold constant")
    ap.add_argument("--num_iterations", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    lp = libmv.read_libmv_file(args.input)
    print(
        f"cameras: {len(lp.cameras)}, points: {len(lp.points)}, "
        f"markers: {len(lp.markers)}, space: "
        f"{'image' if lp.is_image_space else 'normalized'}"
    )
    refine = None if args.refine_intrinsics is None else bool(args.refine_intrinsics)
    problem, cams, pts, intr = libmv.build_problem(lp, refine_intrinsics=refine)
    summary = ct.solve(
        ct.Options(
            linear_solver_type=ct.LinearSolverType.SPARSE_SCHUR,
            max_num_iterations=args.num_iterations,
            minimizer_progress_to_stdout=True,
        ),
        problem,
        device=args.device,
    )
    n = len(lp.markers)
    print(summary.brief_report())
    print(
        f"RMS reprojection error: {np.sqrt(2*summary.initial_cost/n):.4f} -> "
        f"{np.sqrt(2*summary.final_cost/n):.4f} px"
    )
    print("Final intrinsics:", np.round(intr[0], 4))
    return summary


if __name__ == "__main__":
    main()
