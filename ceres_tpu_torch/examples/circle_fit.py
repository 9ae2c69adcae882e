"""Fit a circle to 2-D samples with a robust loss.

The reference's examples/circle_fit.cc: the radius parameterized as
r = m^2 (positivity), the squared-distance residual r^2 - |p - c|^2 (more
convex than the metric distance), and an optional Cauchy loss against
outliers. Data from stdin as "x y" lines, or a synthetic noisy circle with
outliers if stdin is a tty or empty.
"""
import argparse
import sys

import numpy as np

import ceres_tpu_torch as ct


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--robust_threshold", type=float, default=0.0,
                    help="Cauchy loss scale; 0 = no robust loss")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    pts = None
    if not sys.stdin.isatty():
        data = sys.stdin.read().strip()
        if data:
            pts = np.asarray(
                [[float(v) for v in line.split()] for line in data.splitlines()]
            ).reshape(-1, 2)
    if pts is None:
        rng = np.random.default_rng(0)
        th = rng.uniform(0, 2 * np.pi, 120)
        pts = np.stack([3.0 + 7.5 * np.cos(th), -1.0 + 7.5 * np.sin(th)], 1)
        pts += 0.05 * rng.standard_normal(pts.shape)
        pts[::12] += rng.uniform(-8, 8, (10, 2))  # outliers

    x = np.array([np.mean(pts[:, 0])])
    y = np.array([np.mean(pts[:, 1])])
    m = np.array([1.0])  # r = m^2
    init = (x[0], y[0], m[0] ** 2)

    def residual(x, y, m, d):
        r = m[0] * m[0]
        xp = d[0] - x[0]
        yp = d[1] - y[0]
        return r * r - xp * xp - yp * yp

    cost = ct.AutoDiffCostFunction(residual, 1, [1, 1, 1])
    loss = ct.CauchyLoss(args.robust_threshold) if args.robust_threshold else None
    problem = ct.Problem()
    for p in pts:
        problem.add_residual_block(
            cost, loss, [x, y, m], data=(np.float64(p[0]), np.float64(p[1]))
        )
    summary = ct.solve(ct.Options(max_num_iterations=500), problem, device=args.device)
    print(summary.brief_report())
    print(f"x : {init[0]:.6g} -> {x[0]:.6g}")
    print(f"y : {init[1]:.6g} -> {y[0]:.6g}")
    print(f"r : {init[2]:.6g} -> {m[0] ** 2:.6g}")
    return summary


if __name__ == "__main__":
    main()
