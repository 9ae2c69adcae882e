"""Minimize 0.5 (10 - x)^2 with each derivative mode.

Covers the reference's examples/helloworld.cc, helloworld_analytic_diff.cc
and helloworld_numeric_diff.cc: --diff {auto,analytic,numeric} selects
AutoDiffCostFunction, AnalyticCostFunction, or NumericDiffCostFunction
(CENTRAL).
"""
import argparse

import numpy as np
import torch

import ceres_tpu_torch as ct


def make_cost(diff: str):
    if diff == "auto":
        return ct.AutoDiffCostFunction(lambda x: 10.0 - x[0], 1, [1])
    if diff == "numeric":
        return ct.NumericDiffCostFunction(
            lambda x: 10.0 - x[0], 1, [1], method="CENTRAL"
        )

    class QuadraticCost(ct.AnalyticCostFunction):
        num_residuals = 1
        parameter_block_sizes = (1,)

        def residuals(self, params, data=None):
            return torch.stack([10.0 - params[0][0]])

        def jacobians(self, params, data=None):
            return [-torch.ones_like(params[0]).reshape(1, 1)]

    return QuadraticCost()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--diff", choices=("auto", "analytic", "numeric"),
                    default="auto")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    x = np.array([0.5])
    problem = ct.Problem()
    problem.add_residual_block(make_cost(args.diff), None, [x])
    options = ct.Options(minimizer_progress_to_stdout=True)
    summary = ct.solve(options, problem, device=args.device)
    print(summary.brief_report())
    print(f"x : 0.5 -> {x[0]} ({args.diff} derivatives)")
    return summary


if __name__ == "__main__":
    main()
