"""The bundle adjuster's command line over every solver option.

The reference's examples/bundle_adjuster.cc: its flags (:77-146) form the
de-facto command line over the solver's options; this argparse surface
mirrors them.
"""
import argparse

import ceres_tpu_torch as ct
from ceres_tpu_torch.models import bal


def build_options(args) -> ct.Options:
    o = ct.Options()
    o.linear_solver_type = ct.LinearSolverType.parse(args.linear_solver)
    o.preconditioner_type = ct.PreconditionerType.parse(args.preconditioner)
    o.visibility_clustering_type = ct.VisibilityClusteringType.parse(
        args.visibility_clustering
    )
    o.minimizer_type = ct.MinimizerType.parse(args.minimizer)
    o.trust_region_strategy_type = ct.TrustRegionStrategyType.parse(
        args.trust_region_strategy
    )
    o.dogleg_type = ct.DoglegType.parse(args.dogleg)
    o.use_nonmonotonic_steps = args.nonmonotonic_steps
    o.max_num_iterations = args.num_iterations
    o.minimizer_progress_to_stdout = not args.quiet
    o.eta = args.eta
    o.use_inner_iterations = args.inner_iterations
    o.use_mixed_precision_solves = args.mixed_precision_solves
    o.max_num_refinement_iterations = args.max_num_refinement_iterations
    o.use_spse_initialization = args.use_spse_initialization
    o.max_linear_solver_iterations = args.max_linear_solver_iterations
    return o


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", nargs="?", help="BAL file (synthetic if omitted)")
    ap.add_argument("--linear_solver", default="SPARSE_SCHUR",
                    help="dense_qr|dense_normal_cholesky|sparse_normal_cholesky|"
                         "dense_schur|sparse_schur|iterative_schur|cgnr")
    ap.add_argument("--preconditioner", default="JACOBI",
                    help="identity|jacobi|schur_jacobi|schur_power_series_expansion|"
                         "cluster_jacobi|cluster_tridiagonal")
    ap.add_argument("--visibility_clustering", default="CANONICAL_VIEWS")
    ap.add_argument("--minimizer", default="TRUST_REGION")
    ap.add_argument("--trust_region_strategy", default="LEVENBERG_MARQUARDT")
    ap.add_argument("--dogleg", default="TRADITIONAL_DOGLEG")
    ap.add_argument("--nonmonotonic_steps", action="store_true")
    ap.add_argument("--num_iterations", type=int, default=50)
    ap.add_argument("--max_linear_solver_iterations", type=int, default=500)
    ap.add_argument("--eta", type=float, default=1e-2)
    ap.add_argument("--inner_iterations", action="store_true")
    ap.add_argument("--mixed_precision_solves", action="store_true")
    ap.add_argument("--max_num_refinement_iterations", type=int, default=0)
    ap.add_argument("--use_spse_initialization", action="store_true")
    ap.add_argument("--robustify", action="store_true", help="Huber loss")
    ap.add_argument("--rotation_sigma", type=float, default=0.0)
    ap.add_argument("--translation_sigma", type=float, default=0.0)
    ap.add_argument("--point_sigma", type=float, default=0.0)
    ap.add_argument("--random_seed", type=int, default=38401)
    ap.add_argument("--num_cameras", type=int, default=16)
    ap.add_argument("--num_points", type=int, default=2000)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.input:
        data = bal.read_bal_file(args.input)
    else:
        data = bal.synthetic_bal(
            num_cameras=args.num_cameras, num_points=args.num_points,
            visibility=0.2, noise=1.0, seed=args.random_seed,
        )
    if args.rotation_sigma or args.translation_sigma or args.point_sigma:
        data = bal.perturb(
            data, args.rotation_sigma, args.translation_sigma, args.point_sigma,
            seed=args.random_seed,
        )
    problem, cams, pts = bal.build_problem(data, use_huber=args.robustify)
    options = build_options(args)
    summary = ct.solve(options, problem, device=args.device)
    print(summary.full_report())
    return summary


if __name__ == "__main__":
    main()
