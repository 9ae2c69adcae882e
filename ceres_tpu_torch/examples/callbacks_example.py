"""IterationCallback and EvaluationCallback.

The reference's examples/iteration_callback_example.cc (a callback
watching each iteration's state under update_state_every_iteration) and
evaluation_callback_example.cc (an EvaluationCallback that precomputes
shared quantities before each evaluation, the prepare_for_evaluation
contract).
"""
import argparse

import numpy as np
import torch

import ceres_tpu_torch as ct


class SharedPrecompute(ct.EvaluationCallback):
    """Precomputes exp(m x + c) for all samples whenever the solver moves
    to a new evaluation point (evaluation_callback_example.cc's pattern)."""

    def __init__(self, xs, mc):
        self.xs = xs
        self.mc = mc
        self.cache = None
        self.num_prepares = 0

    def prepare_for_evaluation(self, evaluate_jacobians, new_evaluation_point):
        self.num_prepares += 1
        if new_evaluation_point:
            self.cache = np.exp(self.mc[0] * self.xs + self.mc[1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    xs = np.linspace(0, 5, 67)
    ys = np.exp(0.3 * xs + 0.1) + 0.2 * rng.standard_normal(67)

    mc = np.zeros(2)
    cb_state = []

    def iteration_callback(it):
        # update_state_every_iteration makes `mc` live here
        cb_state.append((it.iteration, it.cost, mc.copy()))
        print(f"it {it.iteration:2d} cost {it.cost:.6e} "
              f"m {mc[0]:+.4f} c {mc[1]:+.4f}")
        return ct.CallbackReturnType.SOLVER_CONTINUE

    eval_cb = SharedPrecompute(xs, mc)

    cost = ct.AutoDiffCostFunction(
        lambda mc, d: d[1] - torch.exp(mc[0] * d[0] + mc[1]), 1, [2]
    )
    problem = ct.Problem()
    for x, y in zip(xs, ys):
        problem.add_residual_block(
            cost, None, [mc], data=(np.float64(x), np.float64(y))
        )
    summary = ct.solve(
        ct.Options(
            max_num_iterations=30,
            update_state_every_iteration=True,
            callbacks=[iteration_callback],
            evaluation_callback=eval_cb,
        ),
        problem,
        device=args.device,
    )
    print(summary.brief_report())
    print(f"evaluation callback prepared {eval_cb.num_prepares} times; "
          f"{len(cb_state)} iteration callbacks")
    return summary


if __name__ == "__main__":
    main()
