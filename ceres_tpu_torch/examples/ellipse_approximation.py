"""Ellipse approximation by a closed contour of line segments (the
reference's examples/ellipse_approximation.cc): the contour's control
points X and each data point's preimage position t are optimized jointly.

As in the reference, the purpose is `dynamic_sparsity`: each residual
depends on the whole control-point block, but at any evaluation point
only the two control points around floor(t) have nonzero Jacobian
entries. The problem is numerically dense but dynamically sparse, so the
dynamic solve re-runs the symbolic analysis on each iteration's pattern.

The contour is one (num_segments * 2,) parameter block (the reference
passes all 151 blocks to every residual; one block keeps the kind batched
and the dynamic sparsity pattern explicit), and the preimage positions
are one block per data point.
"""
import argparse
import time

import numpy as np
import torch

import ceres_tpu_torch as ct


def generate_ellipse(num_points: int, seed: int = 1337) -> np.ndarray:
    """Points on a rotated 4:1 ellipse with angular jitter (the data
    recipe of the reference example's comment)."""
    rng = np.random.RandomState(seed)
    t = np.linspace(0.0, 2.0 * np.pi, num_points, endpoint=False)
    t += 2.0 * np.pi * 0.01 * rng.randn(t.size)
    theta = np.deg2rad(15)
    a, b = np.cos(theta), np.sin(theta)
    R = np.array([[a, -b], [b, a]])
    return np.c_[4.0 * np.cos(t), np.sin(t)] @ R.T


def build_problem(Y: np.ndarray, num_segments: int,
                  regularization_weight: float = 1e-2):
    n = num_segments
    # control points start on the unit circle
    w = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    X = np.stack([np.cos(w), np.sin(w)], axis=1).reshape(-1)  # (n*2,)
    # preimage positions start at the closest control point index
    d2 = ((X.reshape(n, 2)[None, :, :] - Y[:, None, :]) ** 2).sum(-1)
    t = np.argmin(d2, axis=1).astype(np.float64)

    problem = ct.Problem()

    def point_to_contour(tb, Xb, data):
        """Distance from data point y to the contour position at preimage
        tb: between the two control points around it
        (PointToLineSegmentContourCostFunction's model). The control
        points are read by index_select, which vmap batches."""
        y = data
        tt = tb[0]
        tt = tt - n * torch.floor(tt / n)
        i0 = torch.floor(tt).to(torch.int64) % n
        i1 = (i0 + 1) % n
        u = tt - torch.floor(tt)
        P = Xb.reshape(n, 2)
        x0 = torch.index_select(P, 0, i0.reshape(1))[0]
        x1 = torch.index_select(P, 0, i1.reshape(1))[0]
        p = (1.0 - u) * x0 + u * x1
        return y - p

    cost = ct.AutoDiffCostFunction(point_to_contour, 2, [1, 2 * n],
                                   name="point_to_contour")
    ts = [np.array([ti]) for ti in t]
    for i in range(Y.shape[0]):
        problem.add_residual_block(cost, None, [ts[i], X], data=Y[i])

    sqrt_w = np.sqrt(regularization_weight)

    def seg_length(Xb):
        """Regularize the contour's total length: all segment vectors at
        once (one kind instead of n two-block residuals)."""
        P = Xb.reshape(n, 2)
        return (sqrt_w * (torch.roll(P, -1, dims=0) - P)).reshape(-1)

    reg = ct.AutoDiffCostFunction(seg_length, 2 * n, [2 * n],
                                  name="contour_length")
    problem.add_residual_block(reg, None, [X])
    return problem, X, ts


def solve(problem, dynamic: bool, max_iters: int, device):
    opts = ct.Options(
        linear_solver_type=ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY,
        dynamic_sparsity=dynamic,
        max_num_iterations=max_iters,
    )
    t0 = time.time()
    s = ct.solve(opts, problem, device=device)
    return s, time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num_points", type=int, default=212)
    ap.add_argument("--num_segments", type=int, default=151)
    ap.add_argument("--max_num_iterations", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    Y = generate_ellipse(args.num_points)

    summaries = []
    for dynamic in (True, False):
        problem, X, ts = build_problem(Y, args.num_segments)
        s, dt = solve(problem, dynamic, args.max_num_iterations, args.device)
        print(f"dynamic_sparsity = {dynamic}")
        print(s.brief_report())
        print(f"wall time {dt:.2f}s")
        summaries.append(s)
    return summaries


if __name__ == "__main__":
    main()
