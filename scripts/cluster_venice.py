"""The cluster preconditioners' clustering at the Venice shape
(chip_smoke.py's VENICE: 13,696 cameras, 1M points), on the host: the
visibility graph, CANONICAL_VIEWS and the degree-2 forest of
ceres_tpu_torch/utils/clustering.py, each timed, and what the cluster
blocks would hold in float64, padded to the largest cluster (the layout
of solvers/linear/preconditioners.ClusterStructure) and at each cluster's
own size.

    python scripts/cluster_venice.py

Takes about 15 s on a CPU; imports nothing of jax.
"""
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from ceres_tpu_torch.models import bal  # noqa: E402
from ceres_tpu_torch.utils import clustering  # noqa: E402


def main():
    b = bal.synthetic_bal_large(**chip_smoke.VENICE)
    t0 = time.perf_counter()
    edges = clustering.compute_visibility_graph(b.point_index, b.camera_index, b.num_cameras)
    t1 = time.perf_counter()
    membership = clustering.canonical_views_clustering(b.num_cameras, edges)
    t2 = time.perf_counter()
    forest = clustering.maximum_spanning_forest_degree2(b.num_cameras, edges, membership)
    t3 = time.perf_counter()
    cols = np.bincount(membership) * 9  # 9 tangent columns a camera
    print(f"cameras {b.num_cameras}, edges {len(edges)} ({t1 - t0:.2f} s); "
          f"canonical views: {cols.size} clusters, the largest {cols.max() // 9} cameras "
          f"({t2 - t1:.2f} s); forest edges {len(forest)} ({t3 - t2:.2f} s); float64 "
          f"blocks padded to m = {cols.max()}: {cols.size * cols.max() ** 2 * 8 / 1e9:.2f} GB, "
          f"each at its own size: {(cols.astype(np.float64) ** 2).sum() * 8 / 1e9:.2f} GB")


if __name__ == "__main__":
    main()
