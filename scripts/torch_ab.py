"""The port on one card, compared between source trees: the wall per LM
iteration on BAL-16, and post_eval_fused's kernel (row 2) at BAL-16 and
at the Venice shape.

    python3 scripts/torch_ab.py TREE [TREE ...]

Each TREE is a checkout of the repo (e.g. the parent commit unpacked with
`git archive` into a git-ignored directory, and the change); give them in
the order parent, change, change, parent, so that drift of the card or the
host shows as a difference between the two runs of one tree. Each tree runs
in its own process with its own `ceres_tpu_torch` first on the path (and
builds its own kernels into its own `build/`). A process prints one JSON
line: the tree, the card's name and power limit, and
- for each BAL-16 configuration, the median and the runs of minimizer ms
  per LM iteration over 5 solves after one that warms up, as
  `chip_smoke.py` measures them;
- row 2's ms per call in float64 and float32 at BAL-16 and Venice, by
  `chip_smoke.time_cuda` (this script's own copy of `chip_smoke.py`, so
  every tree is timed alike), on random J and r (the kernel's work does not
  depend on their values) over the row plan of the shape's structure.
Needs a card; takes about a minute per tree on an H100 once its kernels
are built.
"""
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ("bal16_dense_f64", "bal16_dense_f32", "bal16_iterative_f64")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("ab_chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(tree: Path) -> None:
    sys.path.insert(0, str(tree))
    import torch

    import ceres_tpu_torch as ctt
    from ceres_tpu_torch.models import bal
    from ceres_tpu_torch.ops import flatops as fo
    from ceres_tpu_torch.ops import kernels as kn

    assert Path(ctt.__file__).resolve().is_relative_to(tree), ctt.__file__
    cs = _chip_smoke()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    DS, IS = ctt.LinearSolverType.DENSE_SCHUR, ctt.LinearSolverType.ITERATIVE_SCHUR
    options = {
        "bal16_dense_f64": ctt.Options(linear_solver_type=DS),
        "bal16_dense_f32": ctt.Options(linear_solver_type=DS, evaluation_dtype="float32"),
        "bal16_iterative_f64": ctt.Options(linear_solver_type=IS, max_num_iterations=30,
                                           max_linear_solver_iterations=100),
    }
    out = {"tree": str(tree), "card": card}
    for name in CONFIGS:
        per_it = []
        for k in range(6):
            s = ctt.solve(options[name], bal.build_problem_batched(bal.bal16())[0])
            torch.cuda.synchronize()
            if k:  # the first solve warms up
                per_it.append(1e3 * s.minimizer_time_in_seconds / (len(s.iterations) - 1))
        out[name] = {"ms_per_iteration_median": statistics.median(per_it),
                     "ms_per_iteration_runs": per_it}
    for shape, b, n in (("bal16", bal.bal16(), 100),
                        ("venice", bal.synthetic_bal_large(**cs.VENICE), 20)):
        order = np.argsort(b.point_index, kind="stable")
        plan = fo.build_row_plan(b.point_index[order], b.camera_index[order],
                                 b.num_points, b.num_cameras, "cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        for dt in (torch.float64, torch.float32):
            JT = torch.randn((kn.LANES, plan.B), generator=gen, device="cuda", dtype=dt)
            rT = torch.randn((kn.R, plan.B), generator=gen, device="cuda", dtype=dt)
            ms = cs.time_cuda(lambda: kn.post_eval_fused(JT, rT, plan), n)
            out[f"post_eval_fused_{shape}_{cs.TAG[str(dt)[6:]]}_ms"] = ms
        del plan, b
    print(json.dumps(out), flush=True)


def main(trees) -> int:
    for t in trees:
        tree = Path(t).resolve()
        if not (tree / "ceres_tpu_torch").is_dir():
            print(f"{tree} holds no ceres_tpu_torch", file=sys.stderr)
            return 2
        env = dict(os.environ, PYTHONPATH=str(tree))
        rc = subprocess.run([sys.executable, __file__, "--child", str(tree)], env=env,
                            cwd=tree).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(Path(sys.argv[2]))
    elif len(sys.argv) >= 2:
        sys.exit(main(sys.argv[1:]))
    else:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
