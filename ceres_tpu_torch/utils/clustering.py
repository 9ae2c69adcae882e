"""Visibility graphs and camera clustering for the cluster preconditioners
(counterpart of ceres_tpu/utils/clustering.py; visibility.{h,cc}
ComputeVisibility / CreateSchurComplementGraph, canonical_views_clustering.cc:98,
single_linkage_clustering.cc:57).

Plain numpy on the host, once per solve, as in the JAX package: only the
preconditioner's assembly and apply run on the device. The membership,
the forest and the order of its edges come out as the JAX functions'
(canonical views breaks ties by a strict `>` over float sums, which are
added here in the JAX order). Both the graph and canonical views are
vectorized: ~0.4 s together at 2,048 cameras, where the JAX loops take
~4 s.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def compute_visibility_graph(point_ids: np.ndarray, camera_ids: np.ndarray,
                             num_cameras: int) -> Dict[Tuple[int, int], float]:
    """Camera-camera edge weights from shared-point visibility
    (visibility.cc CreateSchurComplementGraph): weight(i,j) =
    #shared points / sqrt(#points_i * #points_j).

    The edges come in the JAX function's order, the order in which its
    loop first meets each camera pair: points in order of first
    appearance, each point's distinct cameras ascending, pairs (i < j) in
    row-major order."""
    point_ids = np.asarray(point_ids, np.int64)
    camera_ids = np.asarray(camera_ids, np.int64)
    if point_ids.size == 0:
        return {}
    # each point's rank in order of first appearance, its distinct cameras
    uniq_p, first, inv = np.unique(point_ids, return_index=True, return_inverse=True)
    rank = np.argsort(np.argsort(first, kind="stable"), kind="stable")[inv.reshape(-1)]
    pc = np.unique(rank * num_cameras + camera_ids)  # by point rank, cameras ascending
    pt, cam = pc // num_cameras, pc % num_cameras
    counts = np.bincount(cam, minlength=num_cameras)
    # every pair (i < j) of one point's cameras, in order
    size = np.bincount(pt, minlength=uniq_p.size)
    start = np.concatenate([[0], np.cumsum(size)[:-1]])
    pos = np.arange(pc.size) - start[pt]  # a camera's place among its point's
    n_after = size[pt] - pos - 1
    a = np.repeat(np.arange(pc.size), n_after)
    b = a + 1 + (np.arange(a.size) - np.repeat(np.cumsum(n_after) - n_after, n_after))
    key = cam[a] * num_cameras + cam[b]
    ukey, first_pair, shared = np.unique(key, return_index=True, return_counts=True)
    order = np.argsort(first_pair, kind="stable")
    ukey, shared = ukey[order], shared[order]
    i, j = ukey // num_cameras, ukey % num_cameras
    d = np.sqrt(counts[i].astype(np.float64) * counts[j].astype(np.float64))
    w = shared / d
    return {(int(x), int(y)): float(v) for x, y, v in zip(i, j, w)}


def single_linkage_clustering(num_vertices: int,
                              edges: Dict[Tuple[int, int], float],
                              min_similarity: float = 0.9) -> np.ndarray:
    """Union-find merge of edges above threshold
    (single_linkage_clustering.cc:57). Returns cluster id per vertex."""
    parent = np.arange(num_vertices)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for (i, j), w in edges.items():
        if w >= min_similarity:
            ri, rj = find(i), find(j)
            if ri != rj:
                parent[ri] = rj
    roots = {find(i) for i in range(num_vertices)}
    remap = {r: k for k, r in enumerate(sorted(roots))}
    return np.asarray([remap[find(i)] for i in range(num_vertices)], np.int32)


def canonical_views_clustering(
    num_vertices: int,
    edges: Dict[Tuple[int, int], float],
    size_penalty_weight: float = 5.0,
    similarity_penalty_weight: float = 100.0,
    min_views: int = 0,
) -> np.ndarray:
    """Greedy canonical-view selection (canonical_views_clustering.cc:98,
    Simon et al. "Scene Summarization for Online Image Collections"
    objective): repeatedly add the view maximizing
      sum_i max(0, sim(i, c) - max_sim_to_existing(i))
      - size_penalty - similarity_penalty * sim(c, existing)
    then assign every vertex to its most similar canonical view.

    Each round scores every candidate at once: its terms (its own coverage,
    then each neighbour's in adjacency order) summed left to right by a
    cumulative sum, then the penalties subtracted in order, so every gain
    is the JAX loop's float sum bit for bit, and the first of the largest
    gains wins, as the JAX loop's strict `>` picks it."""
    adj: List[Dict[int, float]] = [dict() for _ in range(num_vertices)]
    for (i, j), w in edges.items():
        adj[i][j] = w
        adj[j][i] = w
    width = max((len(a) for a in adj), default=0)
    nbr = np.zeros((num_vertices, width), np.int64)
    wts = np.zeros((num_vertices, width))
    valid = np.zeros((num_vertices, width), bool)
    for v, a in enumerate(adj):
        nbr[v, :len(a)] = list(a)
        wts[v, :len(a)] = list(a.values())
        valid[v, :len(a)] = True
    canonical: List[int] = []
    penalties = []  # similarity_penalty_weight * sim(v, c) of each canonical c
    is_canonical = np.zeros(num_vertices, bool)
    best_sim = np.zeros(num_vertices)
    terms = np.empty((num_vertices, width + 1))
    while num_vertices:
        # coverage improvement (v covers itself with sim 1), then its neighbours'
        terms[:, 0] = np.maximum(0.0, 1.0 - best_sim)
        terms[:, 1:] = np.where(valid, np.maximum(0.0, wts - best_sim[nbr]), 0.0)
        gain = np.cumsum(terms, axis=1)[:, -1] - size_penalty_weight
        for pen in penalties:
            gain = gain - pen
        gain[is_canonical] = -np.inf
        best_v = int(np.argmax(gain))
        if is_canonical[best_v] or gain[best_v] <= 0.0:
            break
        canonical.append(best_v)
        is_canonical[best_v] = True
        penalties.append(similarity_penalty_weight
                         * np.array([a.get(best_v, 0.0) for a in adj]))
        best_sim[best_v] = 1.0
        for u, w in adj[best_v].items():
            best_sim[u] = max(best_sim[u], w)
        if len(canonical) >= num_vertices:
            break
    if not canonical:
        canonical = [0]
    # assignment
    membership = np.zeros(num_vertices, np.int32)
    for v in range(num_vertices):
        best_w, best_c = -1.0, 0
        for k, c in enumerate(canonical):
            w = 1.0 if v == c else adj[v].get(c, 0.0)
            if w > best_w:
                best_w, best_c = w, k
        membership[v] = best_c
    return membership


def maximum_spanning_forest_degree2(
    num_vertices: int, edges: Dict[Tuple[int, int], float], membership: np.ndarray
) -> List[Tuple[int, int]]:
    """Degree-2-constrained maximum spanning forest over the *cluster*
    graph (visibility_based_preconditioner.h:95-140 ForestEdges for
    CLUSTER_TRIDIAGONAL): greedy over cluster-pair weights."""
    from collections import defaultdict

    num_clusters = int(membership.max()) + 1 if num_vertices else 0
    cw = defaultdict(float)
    for (i, j), w in edges.items():
        ci, cj = int(membership[i]), int(membership[j])
        if ci != cj:
            cw[(min(ci, cj), max(ci, cj))] += w
    order = sorted(cw.items(), key=lambda kv: -kv[1])
    degree = np.zeros(num_clusters, np.int32)
    parent = np.arange(num_clusters)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    forest = []
    for (i, j), w in order:
        if degree[i] >= 2 or degree[j] >= 2:
            continue
        ri, rj = find(i), find(j)
        if ri == rj:
            continue
        parent[ri] = rj
        degree[i] += 1
        degree[j] += 1
        forest.append((i, j))
    return forest
