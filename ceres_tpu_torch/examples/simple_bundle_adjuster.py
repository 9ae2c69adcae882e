"""Bundle adjustment on a BAL file or a synthetic instance (the
reference's examples/simple_bundle_adjuster.cc)."""
import argparse

import ceres_tpu_torch as ct
from ceres_tpu_torch.models import bal


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("bal_file", nargs="?", help="BAL problem file; synthetic if omitted")
    ap.add_argument("--linear_solver", default="SPARSE_SCHUR")
    ap.add_argument("--max_iterations", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.bal_file:
        problem_data = bal.read_bal_file(args.bal_file)
    else:
        b = bal.synthetic_bal(num_cameras=16, num_points=1000, visibility=0.25,
                              noise=1.0, seed=0)
        problem_data = bal.perturb(b, 0.02, 0.2, 0.2, seed=1)
    print(
        f"cameras: {problem_data.num_cameras}, points: {problem_data.num_points}, "
        f"observations: {problem_data.num_observations}"
    )
    problem, cams, pts = bal.build_problem(problem_data)
    options = ct.Options(
        linear_solver_type=ct.LinearSolverType.parse(args.linear_solver),
        max_num_iterations=args.max_iterations,
        minimizer_progress_to_stdout=True,
    )
    summary = ct.solve(options, problem, device=args.device)
    print(summary.full_report())
    return summary


if __name__ == "__main__":
    main()
