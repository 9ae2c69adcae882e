"""Which collectives the gloo backend of torch.distributed takes on CUDA
tensors, with two ranks sharing one card.

    python scripts/gloo_cuda_probe.py [--ranks 2]

Each collective runs in a process group of its own (a fresh pair of
processes), so that one the backend refuses cannot leave the next in a
broken group. Prints one JSON line: {collective: "ok" | the error's first
line}. The mesh (ceres_tpu_torch/parallel/mesh.py) stages through host
memory the collectives this finds refused; run it after a PyTorch upgrade.
"""
import argparse
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "all_to_all_single",
               "broadcast", "reduce_scatter_tensor")


def _rank(rank, world, store, name, out_dir):
    dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    x = torch.arange(4 * world, dtype=torch.float64, device=dev) + rank
    try:
        if name == "all_reduce":
            dist.all_reduce(x)
        elif name == "all_gather_into_tensor":
            out = x.new_empty(world * x.numel())
            dist.all_gather_into_tensor(out, x)
        elif name == "all_to_all_single":
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x)
        elif name == "broadcast":
            dist.broadcast(x, 0)
        else:
            out = x.new_empty(4)
            dist.reduce_scatter_tensor(out, x)
        torch.cuda.synchronize()
        res = "ok"
    except Exception as e:  # noqa: BLE001 - the probe reports what refused
        res = (str(e).strip().splitlines() or [type(e).__name__])[0][:200]
    with open(os.path.join(out_dir, f"{name}.{rank}"), "w") as f:
        f.write(res)
    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    result = {}
    for name in COLLECTIVES:
        with tempfile.TemporaryDirectory() as tmp:
            store = "file://" + os.path.join(tmp, "store")
            ctx = mp.get_context("spawn")
            procs = [ctx.Process(target=_rank, args=(r, a.ranks, store, name, tmp))
                     for r in range(a.ranks)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(120)
                if p.is_alive():
                    p.kill()
            got = []
            for r in range(a.ranks):
                path = os.path.join(tmp, f"{name}.{r}")
                got.append(open(path).read() if os.path.exists(path) else "no answer")
            result[name] = got[0] if len(set(got)) == 1 else got
    print(json.dumps({"torch": torch.__version__, "gloo_on_cuda": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
