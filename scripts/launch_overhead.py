"""The host's time a kernel launch takes through a wrapper of
ceres_tpu_torch/ops/kernels.py, compared between source trees: what making
the tensors' card current around every launch (kernels._launch) costs.

    python3 scripts/launch_overhead.py TREE [TREE ...]

Each TREE is a checkout of the repo (e.g. the parent commit unpacked with
`git archive` into a git-ignored directory, and the change); give them in
the order parent, change, change, parent. Each tree runs in its own process
with its own `ceres_tpu_torch` first on the path and builds its own kernels
into its own `build/`. A process prints one JSON line: the tree, the card's
name and power limit, and for segment_block_expand (row 7) at a tiny shape
(16 rows of a 64 x 3 table, float64), whose launch the host bounds, the
median over 5 rounds of the microseconds per call of 20,000 calls, timed on
the host clock with the card synchronized before and after each round,
with the tensors on the current card. Needs a card.
"""
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

CALLS = 20_000
ROUNDS = 5


def child(tree: Path) -> None:
    sys.path.insert(0, str(tree))
    import torch

    from ceres_tpu_torch.ops import build
    from ceres_tpu_torch.ops import kernels as kn

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    build.load()
    out = {"tree": str(tree), "card": card, "calls": CALLS}
    dev = torch.device("cuda", torch.cuda.current_device())
    vals = torch.randn(64, 3, dtype=torch.float64, device=dev)
    ids = torch.randint(0, 64, (16,), dtype=torch.int32, device=dev)
    assert torch.equal(kn.segment_block_expand(vals, ids), torch.index_select(vals, 0, ids))
    rounds = []
    for _ in range(ROUNDS):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        for _ in range(CALLS):
            kn.segment_block_expand(vals, ids)
        torch.cuda.synchronize(dev)
        rounds.append(1e6 * (time.perf_counter() - t) / CALLS)
    out["us_per_call"] = statistics.median(rounds)
    out["rounds"] = rounds
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
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--child":
        child(Path(args[1]))
    elif args:
        sys.exit(main(args))
    else:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
