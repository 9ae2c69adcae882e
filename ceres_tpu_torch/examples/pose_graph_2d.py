"""2D pose graph SLAM (the reference's examples/slam/pose_graph_2d)."""
import argparse

import ceres_tpu_torch as ct
from ceres_tpu_torch.models import pose_graph as pg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", help="g2o file (synthetic circle if omitted)")
    ap.add_argument("--num_poses", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.input:
        poses, constraints = pg.read_g2o_2d(args.input)
    else:
        poses, constraints, _ = pg.synthetic_2d(num_poses=args.num_poses)
    print(f"Number of poses: {len(poses)}; constraints: {len(constraints)}")
    problem, arrays = pg.build_problem_2d(poses, constraints)
    summary = ct.solve(
        ct.Options(
            linear_solver_type=ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY,
            max_num_iterations=100,
            minimizer_progress_to_stdout=True,
        ),
        problem,
        device=args.device,
    )
    print(summary.brief_report())
    return summary


if __name__ == "__main__":
    main()
