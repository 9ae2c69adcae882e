"""The NIST StRD suite (the reference's examples/nist.cc): solves every
certified start of each problem (or of --problem alone) and prints its LRE
digits, the successes per difficulty and in total.

Usage: python -m ceres_tpu_torch.examples.nist --nist_data_dir DIR
       [--problem Misra1a.dat] [--device cpu]

DIR holds the StRD .dat files (the JAX script's default names the
reference checkout's data/nist; here the default is data/nist under the
working directory).
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nist_data_dir", default="data/nist")
    ap.add_argument("--problem", default=None, help="single .dat file name")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ceres_tpu_torch.models import nist

    subset = [args.problem] if args.problem else None
    summaries = {}
    results = nist.run_suite(args.nist_data_dir, subset=subset, device=args.device,
                             summaries=summaries)
    tiers = {"easy": [], "medium": [], "hard": []}
    tier_of = {f: t for (f, _, _, t) in nist.SUITE}
    total = success = 0
    for fname, runs in results.items():
        for start, (lre, ok) in enumerate(runs):
            status = "SUCCESS" if ok else "FAILURE"
            print(f"{fname:16s} start {start + 1}: {status} lre: {float(lre):5.1f}")
            total += 1
            success += bool(ok)
            tiers[tier_of[fname]].append(bool(ok))
    for t in ("easy", "medium", "hard"):
        if tiers[t]:
            print(f"{t}: {sum(tiers[t])}/{len(tiers[t])}")
    print(f"Total: {success}/{total}")
    return [s for runs in summaries.values() for s in runs]


if __name__ == "__main__":
    main()
