"""EvaluationCallback and Jacobians the user supplies (the reference's
examples/evaluation_callback_example.cc): the callback is told before
every residual and Jacobian evaluation, the hook for preparing shared
computation outside the solver, and the cost function supplies
closed-form Jacobians (AnalyticCostFunction) instead of autodiff. The
results must be those of the autodiff fit.

The evaluation of every block is one batched pass already, so the
reference's copy out of a shared buffer for vectorization has no
counterpart; what is exercised is the callback's contract: the
evaluate_jacobians and new_evaluation_point notices, in evaluation order.
"""
import argparse

import numpy as np
import torch

import ceres_tpu_torch as ct


def generate_data(m=0.3, c=0.1, n=67, noise=0.2, seed=23497):
    rng = np.random.RandomState(seed)
    x = np.arange(n) * 0.075
    y = np.exp(m * x + c) + noise * rng.randn(n)
    return x, y


class ExponentialCost(ct.AnalyticCostFunction):
    """r = y - exp(m x + c) with a hand-written Jacobian (a
    SizedCostFunction's counterpart)."""

    num_residuals = 1
    parameter_block_sizes = (2,)

    def residuals(self, params, data=None):
        (mc,) = params
        x, y = data
        return (y - torch.exp(mc[0] * x + mc[1])).reshape(1)

    def jacobians(self, params, data=None):
        (mc,) = params
        x, _ = data
        e = torch.exp(mc[0] * x + mc[1])
        return [torch.stack([-x * e, -e]).reshape(1, 2)]


class CountingCallback(ct.EvaluationCallback):
    """Tracks the evaluation-point protocol (evaluation_callback.h:63):
    new_evaluation_point=True exactly when the solver moved x since the
    previous prepare call."""

    def __init__(self):
        self.calls = 0
        self.new_points = 0

    def prepare_for_evaluation(self, evaluate_jacobians, new_evaluation_point):
        self.calls += 1
        if new_evaluation_point:
            self.new_points += 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    xs, ys = generate_data()

    cb = CountingCallback()
    mc = np.array([0.0, 0.0])
    problem = ct.Problem()
    cost = ExponentialCost()
    for x, y in zip(xs, ys):
        problem.add_residual_block(
            cost, None, [mc], data=(np.float64(x), np.float64(y)))
    opts = ct.Options(max_num_iterations=50, evaluation_callback=cb)
    s = ct.solve(opts, problem, device=args.device)
    print(s.brief_report())
    print(f"analytic-Jacobian fit: m = {mc[0]:.6f}, c = {mc[1]:.6f}")
    print(f"callback: {cb.calls} prepare calls, {cb.new_points} new points")

    # must match the autodiff version (curve_fitting.py) exactly
    mc2 = np.array([0.0, 0.0])
    problem2 = ct.Problem()
    auto = ct.AutoDiffCostFunction(
        lambda p, data: (data[1] - torch.exp(p[0] * data[0] + p[1])).reshape(1),
        1, [2])
    for x, y in zip(xs, ys):
        problem2.add_residual_block(
            auto, None, [mc2], data=(np.float64(x), np.float64(y)))
    s2 = ct.solve(ct.Options(max_num_iterations=50), problem2, device=args.device)
    print(f"autodiff fit:          m = {mc2[0]:.6f}, c = {mc2[1]:.6f}")
    assert abs(mc[0] - mc2[0]) < 1e-8 and abs(mc[1] - mc2[1]) < 1e-8
    assert cb.calls > 0 and cb.new_points > 0
    print("identical results — OK")
    return [s, s2]


if __name__ == "__main__":
    main()
