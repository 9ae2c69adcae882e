"""More-Garbow-Hillstrom test problems, solved one after another.

The reference's examples/more_garbow_hillstrom.cc (:550-640): solves MGH
problems 1-19 from initial_x * 10^trial for the trials given, unconstrained
or (where certified) bounds-constrained, scoring >= 4 relative log digits
on the sum of squares.

Usage: python -m ceres_tpu_torch.examples.more_garbow_hillstrom
       [--problem N] [--trials 0,1,2] [--constrained] [--device cpu]
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--problem", type=int, default=None,
                    help="single problem number (default: all)")
    ap.add_argument("--trials", default="0",
                    help="comma-separated start scalings 10^t")
    ap.add_argument("--constrained", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ceres_tpu_torch.models import mgh

    trials = tuple(int(t) for t in args.trials.split(","))
    problems = [p for p in mgh.PROBLEMS
                if args.problem is None or p.number == args.problem]
    total = successes = 0
    summaries = []
    for p in problems:
        if args.constrained and p.constrained_optimal_cost is None:
            continue
        for t in trials:
            ok, achieved, s = mgh.solve_problem(p, args.constrained, t,
                                                device=args.device)
            total += 1
            successes += ok
            summaries.append(s)
            print(f"MGH {p.number:2d} {p.name:22s} trial {t}: "
                  f"{'Yes' if ok else 'No '}  2*cost={achieved:.6g} "
                  f"({s.termination_type}, {len(s.iterations)} it)")
    print(f"{successes}/{total} successes "
          f"({'constrained' if args.constrained else 'unconstrained'})")
    return summaries


if __name__ == "__main__":
    main()
