"""Rank programs for the launcher's failure tests (tests/test_torch_sharding.py):
importable by the spawned ranks, and free of JAX."""
import time

import torch


def raising_rank(mesh):
    """Rank 1 raises before the collective the others wait in."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return mesh.psum(torch.ones(1))


def stuck_rank(mesh):
    """Rank 1 never joins the collective rank 0 waits in."""
    if mesh.rank == 1:
        time.sleep(600)
    return mesh.psum(torch.ones(1))
