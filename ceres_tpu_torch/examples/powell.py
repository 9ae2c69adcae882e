"""Powell's singular function (the reference's examples/powell.cc)."""
import argparse
import math

import numpy as np

import ceres_tpu_torch as ct


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    x1 = np.array([3.0])
    x2 = np.array([-1.0])
    x3 = np.array([0.0])
    x4 = np.array([1.0])
    p = ct.Problem()
    p.add_residual_block(
        ct.AutoDiffCostFunction(lambda a, b: a[0] + 10 * b[0], 1, [1, 1]), None, [x1, x2]
    )
    p.add_residual_block(
        ct.AutoDiffCostFunction(lambda a, b: math.sqrt(5.0) * (a[0] - b[0]), 1, [1, 1]),
        None,
        [x3, x4],
    )
    p.add_residual_block(
        ct.AutoDiffCostFunction(lambda a, b: (a[0] - 2 * b[0]) ** 2, 1, [1, 1]),
        None,
        [x2, x3],
    )
    p.add_residual_block(
        ct.AutoDiffCostFunction(
            lambda a, b: math.sqrt(10.0) * (a[0] - b[0]) ** 2, 1, [1, 1]
        ),
        None,
        [x1, x4],
    )
    options = ct.Options(
        linear_solver_type=ct.LinearSolverType.DENSE_QR,
        max_num_iterations=100,
        minimizer_progress_to_stdout=True,
    )
    print(f"Initial x1 = {x1[0]}, x2 = {x2[0]}, x3 = {x3[0]}, x4 = {x4[0]}")
    summary = ct.solve(options, p, device=args.device)
    print(summary.full_report())
    print(f"Final x1 = {x1[0]:.3g}, x2 = {x2[0]:.3g}, x3 = {x3[0]:.3g}, x4 = {x4[0]:.3g}")
    return summary


if __name__ == "__main__":
    main()
