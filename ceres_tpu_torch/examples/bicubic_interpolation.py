"""2-D shift estimation through a BiCubicInterpolator under autodiff.

The reference's examples/bicubic_interpolation.cc (:30-140):
f(x, y) = x^2 - y x + y^2 sampled on a 19 x 23 grid, and the shift
(s_x, s_y) recovered from 4 shifted samples by differentiating through
the interpolator (the bicubic interpolation of a quadratic is exact, so
the solve converges to machine precision).
"""
import argparse

import numpy as np
import torch

import ceres_tpu_torch as ct
from ceres_tpu_torch.cubic_interpolation import BiCubicInterpolator, Grid2D


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows_half, cols_half = 9, 11
    true_shift = np.asarray([1.234, 2.345])

    def f(x, y):
        return x * x - y * x + y * y

    ys, xs = np.mgrid[-rows_half: rows_half + 1, -cols_half: cols_half + 1]
    grid = Grid2D(torch.as_tensor(f(xs.astype(float), ys.astype(float)),
                                  device=args.device))
    interp = BiCubicInterpolator(grid)

    points = np.asarray([[-2.0, -3.0], [-2.0, 3.0], [2.0, 3.0], [2.0, -3.0]])
    values = [f(p[0] + true_shift[0], p[1] + true_shift[1]) for p in points]

    def residual(s, d):
        px, py, v = d
        # grid row index = y + rows_half, column index = x + cols_half
        return interp(py + s[1] + rows_half, px + s[0] + cols_half) - v

    shift = np.zeros(2)
    problem = ct.Problem()
    for p, v in zip(points, values):
        problem.add_residual_block(
            ct.AutoDiffCostFunction(residual, 1, [2]),
            None,
            [shift],
            data=(np.float64(p[0]), np.float64(p[1]), np.float64(v)),
        )
    summary = ct.solve(ct.Options(max_num_iterations=100), problem, device=args.device)
    print(summary.brief_report())
    print(f"shift: (0, 0) -> ({shift[0]:.6f}, {shift[1]:.6f}) "
          f"[true ({true_shift[0]}, {true_shift[1]})]")
    return summary


if __name__ == "__main__":
    main()
