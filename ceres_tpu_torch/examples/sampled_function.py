"""A cost function over sampled data through cubic interpolation (the
reference's examples/sampled_function/sampled_function.cc)."""
import argparse

import numpy as np
import torch

import ceres_tpu_torch as ct


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # f(x) = (x - 4.5)^2 sampled on a grid, the grid on the solve's device
    xs = np.arange(10.0)
    values = (xs - 4.5) ** 2
    interp = ct.CubicInterpolator(ct.Grid1D(torch.as_tensor(values, device=args.device)))

    x = np.array([1.0])
    problem = ct.Problem()
    problem.add_residual_block(
        ct.AutoDiffCostFunction(lambda v: torch.atleast_1d(interp(v[0])), 1, [1]),
        None,
        [x],
    )
    summary = ct.solve(ct.Options(max_num_iterations=50), problem, device=args.device)
    print(summary.brief_report())
    print(f"Expected x: 4.5, actual x: {x[0]:.6f}")
    return summary


if __name__ == "__main__":
    main()
