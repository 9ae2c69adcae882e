"""1D robot localization MLE with odometry and range readings (the
reference's examples/robot_pose_mle.cc): odometry constraints between
consecutive poses and range residuals against a wall at the corridor's
length. The range cost's parameter count (all poses so far) varies per
residual block, as a DynamicAutoDiffCostFunction's does; each count forms
its own kind.
"""
import argparse

import numpy as np
import torch

import ceres_tpu_torch as ct

ODOMETRY_STDDEV = 0.1
RANGE_STDDEV = 0.01
CORRIDOR_LENGTH = 30.0
POSE_SEPARATION = 0.5


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num_steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(1)
    n = args.num_steps
    # simulate
    true_deltas = np.full(n, POSE_SEPARATION)
    odometry = true_deltas + rng.normal(0, ODOMETRY_STDDEV, n)
    positions = np.cumsum(true_deltas)
    ranges = (CORRIDOR_LENGTH - positions) + rng.normal(0, RANGE_STDDEV, n)

    deltas = [np.asarray([odometry[i]]) for i in range(n)]
    problem = ct.Problem()
    odo_cost = ct.AutoDiffCostFunction(
        lambda d, obs: (d[0] - obs) / ODOMETRY_STDDEV, 1, [1], name="odometry"
    )
    for i in range(n):
        problem.add_residual_block(
            odo_cost, None, [deltas[i]], data=np.float64(odometry[i])
        )
    # the range constraint takes all deltas up to i: one kind per i
    for i in range(n):
        k = i + 1

        def make_range(k):
            def f(*args):
                ds, obs = args[:-1], args[-1]
                pos = torch.sum(torch.stack([d[0] for d in ds]))
                return (CORRIDOR_LENGTH - pos - obs) / RANGE_STDDEV

            return f

        cost = ct.AutoDiffCostFunction(make_range(k), 1, [1] * k, name=f"range{k}")
        problem.add_residual_block(
            cost, None, deltas[:k], data=np.float64(ranges[i])
        )
    summary = ct.solve(ct.Options(max_num_iterations=100), problem, device=args.device)
    print(summary.brief_report())
    est = np.cumsum([d[0] for d in deltas])
    err = np.abs(est - positions)
    print(f"mean |pose error| = {err.mean():.4f} m (odometry-only would be "
          f"{np.abs(np.cumsum(odometry) - positions).mean():.4f} m)")
    return summary


if __name__ == "__main__":
    main()
