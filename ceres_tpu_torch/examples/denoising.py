"""Fields-of-Experts image denoising (the reference's
examples/denoising.cc): reads a PGM image and an FoE model, builds the
problem one residual block at a time, solves it with CGNR and writes the
denoised image.

Usage: python -m ceres_tpu_torch.examples.denoising --input noisy.pgm
       --foe_file model.foe [--output out.pgm] [--crop N]
       [--num_iterations 20] [--device cpu]

The JAX script's defaults name the reference checkout's
data/ceres_noisy.pgm and data/2x2.foe; here they are data/ under the
working directory, and the output ceres_denoised.pgm there.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", default="data/ceres_noisy.pgm")
    ap.add_argument("--foe_file", default="data/2x2.foe")
    ap.add_argument("--output", default="ceres_denoised.pgm")
    ap.add_argument("--sigma", type=float, default=20.0)
    ap.add_argument("--crop", type=int, default=0, help="optional square crop")
    ap.add_argument("--num_iterations", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import ceres_tpu_torch as ct
    from ceres_tpu_torch.models import denoising

    foe = denoising.read_foe_file(args.foe_file)
    image = denoising.read_pgm(args.input)
    if args.crop:
        image = image[:args.crop, :args.crop].copy()
    print(f"image {image.shape}, foe {foe.size}x{foe.size} x{foe.num_filters}")
    problem, pixels = denoising.create_problem(foe, image, args.sigma)
    summary = ct.solve(
        ct.Options(linear_solver_type=ct.LinearSolverType.CGNR,
                   max_num_iterations=args.num_iterations,
                   minimizer_progress_to_stdout=True),
        problem, device=args.device)
    print(summary.brief_report())
    denoising.write_pgm(args.output, denoising.pixels_to_image(pixels))
    print(f"wrote {args.output}")
    return summary


if __name__ == "__main__":
    main()
