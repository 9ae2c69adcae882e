"""Exponential curve fit, optionally robustified (the reference's
examples/curve_fitting.cc and robust_curve_fitting.cc). Run with --robust
to add CauchyLoss against outliers."""
import argparse

import numpy as np
import torch

import ceres_tpu_torch as ct


# The 67 observations of curve_fitting.cc (y = exp(0.3 x + 0.1) + noise).
def generate_data(robust=False, seed=0):
    rng = np.random.default_rng(seed)
    xs = np.linspace(0.0, 5.0, 67)
    ys = np.exp(0.3 * xs + 0.1) + 0.2 * rng.standard_normal(67)
    if robust:
        ys[::11] += 8.0  # gross outliers
    return xs, ys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--robust", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    xs, ys = generate_data(args.robust)

    cost = ct.AutoDiffCostFunction(
        lambda mc, d: d[1] - torch.exp(mc[0] * d[0] + mc[1]), 1, [2]
    )
    loss = ct.CauchyLoss(0.5) if args.robust else None
    mc = np.zeros(2)
    problem = ct.Problem()
    for x, y in zip(xs, ys):
        problem.add_residual_block(cost, loss, [mc], data=(np.float64(x), np.float64(y)))
    summary = ct.solve(ct.Options(max_num_iterations=50), problem, device=args.device)
    print(summary.brief_report())
    print(f"Initial m: 0 c: 0 -> Final m: {mc[0]:.5f} c: {mc[1]:.5f} (truth 0.3, 0.1)")
    return summary


if __name__ == "__main__":
    main()
