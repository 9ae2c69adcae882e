"""Rosenbrock through GradientProblem with a selectable derivative mode.

Covers the reference's examples/rosenbrock.cc (autodiff),
rosenbrock_analytic_diff.cc (a hand-coded gradient) and
rosenbrock_numeric_diff.cc (central differences): --diff
{auto,analytic,numeric}.
"""
import argparse

import numpy as np
import torch

import ceres_tpu_torch as ct
from ceres_tpu_torch.gradient_problem import GradientProblem, solve_gradient_problem


def f(v):
    return (1.0 - v[0]) ** 2 + 100.0 * (v[1] - v[0] ** 2) ** 2


def analytic_grad(v):
    return torch.stack([
        -2.0 * (1.0 - v[0]) - 400.0 * v[0] * (v[1] - v[0] ** 2),
        200.0 * (v[1] - v[0] ** 2),
    ])


def numeric_grad(v):
    h = 1e-6
    e = torch.eye(2, dtype=v.dtype, device=v.device)
    return torch.stack([
        (f(v + h * e[i]) - f(v - h * e[i])) / (2.0 * h) for i in range(2)
    ])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--diff", choices=("auto", "analytic", "numeric"),
                    default="auto")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    x = np.array([-1.2, 1.0])
    grad = {"auto": None, "analytic": analytic_grad,
            "numeric": numeric_grad}[args.diff]
    problem = GradientProblem(f, 2, gradient=grad)
    options = ct.Options(
        minimizer_type=ct.MinimizerType.LINE_SEARCH,
        line_search_direction_type=ct.LineSearchDirectionType.LBFGS,
        max_num_iterations=200,
        minimizer_progress_to_stdout=True,
    )
    summary = solve_gradient_problem(options, problem, x, device=args.device)
    print(summary.brief_report())
    print(f"Final x: {x} ({args.diff} derivatives)")
    return summary


if __name__ == "__main__":
    main()
