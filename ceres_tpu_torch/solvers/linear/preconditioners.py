"""Preconditioners of the iterative solvers beyond the block-Jacobi ones
(counterpart of ceres_tpu/solvers/linear/preconditioners.py):

 - the power series expansion SCHUR_POWER_SERIES_EXPANSION
   (power_series_expansion_preconditioner.h:40-66, Weber et al., "Power
   Bundle Adjustment"): a truncated Neumann series over S products;
 - CLUSTER_JACOBI and CLUSTER_TRIDIAGONAL
   (visibility_based_preconditioner.{h,cc}:127-578): the cameras clustered
   by shared-point visibility (utils/clustering.py), S restricted to the
   camera pairs within a cluster (and, tridiagonal, along the edges of a
   degree-2 forest of clusters), factored as one batched Cholesky over the
   (C, m, m) blocks padded to the largest cluster, or as a batched
   block-tridiagonal Cholesky along the forest's chains;
 - SUBSET (subset_preconditioner.h:70): (Q'Q + D^2)^{-1} over a chosen
   subset of the residual blocks, factored on the host.

SCHUR_JACOBI and JACOBI are the iterative steps' own (implicit_schur.py,
cgnr.py). The cluster blocks are formed on the device in float64 whatever
the evaluation dtype, from the pair plans of sparse_schur.SchurPairs
restricted to the pairs the blocks hold: each pair's products summed by
segment_block_sum (kernel 6) in a fixed order, the sums gathered into the
(C, m, m) layout by segment_block_expand (kernel 7); no atomics, so a
float64 step repeats bit for bit. The factorizations run through
torch.linalg's batched Cholesky without a host sync: where the tridiagonal
restriction is not positive definite, the cluster-Jacobi factors take its
place, decided on the device.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ... import native
from ...ops import flatops as fo
from ...ops import kernels as kn
from ...ops import partition as pt
from ...ops.inner_product import InnerProductComputer, PairSumPlan
from .sparse_schur import SchurPairs

_F64 = torch.float64

# the last clustering build_cluster made (a record for the smoke run):
# clusters, largest cluster's columns, chains, forest edges, host seconds
STATS = {}


def power_series(p_inv: Callable, multiply: Callable, num_terms: int) -> Callable:
    """v -> sum_{i <= num_terms} (I - P^{-1} S)^i P^{-1} v, for P^{-1}
    `p_inv` and S `multiply`."""

    def apply(v):
        t = p_inv(v)
        acc = t
        for _ in range(num_terms):
            t = t - p_inv(multiply(t))
            acc = acc + t
        return acc

    return apply


def make_spse_preconditioner(pm: pt.PartitionedMeta, values, sys, D_f: torch.Tensor,
                             num_terms: int, multiply_fn: Optional[Callable] = None):
    """S^{-1} ~= sum_{i <= k} (I - P^{-1} S)^i P^{-1}, P the block
    diagonal of S (SCHUR_JACOBI); `multiply_fn` the S product, by default
    the implicit one."""
    from .implicit_schur import make_schur_jacobi_preconditioner, schur_multiply

    if multiply_fn is None:
        def multiply_fn(t):
            return schur_multiply(pm, values, sys, D_f, t)

    return power_series(make_schur_jacobi_preconditioner(pm, values, sys, D_f),
                        multiply_fn, num_terms)


class ClusterStructure:
    """The camera clusters on the host, and their index tables on the
    device: membership of each f block (in the order of the f families'
    blocks), each cluster's tangent indices padded to the largest cluster
    (`gather` (C, m), the pad f_size; `mask`), and for CLUSTER_TRIDIAGONAL
    (`forest_edges` given) the chains the degree-2 forest's components
    form, walked from an end (lowest degree first, clusters in order among
    equals), `parent_of` each cluster's predecessor along its chain and
    `chain_clusters` (num_chains, longest) with the pad C."""

    def __init__(self, pm: pt.PartitionedMeta, membership: np.ndarray,
                 forest_edges: Optional[list] = None, device="cpu"):
        self.pm = pm
        self.device = torch.device(device)
        # canonical membership ids 0..C-1 (position == id below)
        membership = np.asarray(membership, np.int64)
        uniq, membership = np.unique(membership, return_inverse=True)
        membership = membership.reshape(-1)
        if forest_edges is not None:
            remap = {int(u): i for i, u in enumerate(uniq)}
            forest_edges = [(remap[int(i)], remap[int(j)]) for (i, j) in forest_edges
                            if int(i) in remap and int(j) in remap]
        self.membership = membership
        self.chains = None
        if forest_edges is not None:
            # a degree-2 forest's components are paths: walk each from an end
            num_c = len(uniq)
            adj: List[List[int]] = [[] for _ in range(num_c)]
            for (i, j) in forest_edges:
                adj[i].append(j)
                adj[j].append(i)
            visited = [False] * num_c
            chains = []
            for c in sorted(range(num_c), key=lambda c: len(adj[c])):  # stable
                if visited[c]:
                    continue
                chain = [c]
                visited[c] = True
                cur = c
                while True:
                    nxt = [x for x in adj[cur] if not visited[x]]
                    if not nxt:
                        break
                    cur = nxt[0]
                    visited[cur] = True
                    chain.append(cur)
                chains.append(chain)
            self.chains = chains
        # each cluster's tangent indices over the f partition (blocks of
        # every f family in turn)
        clusters: dict = {}
        cam = 0
        for (off, nv, t, _) in pm.f_fams:
            for i in range(nv):
                c = int(membership[cam]) if cam < len(membership) else 0
                clusters.setdefault(c, []).append((off + i * t, t))
                cam += 1
        self.cluster_indices = []
        for c in sorted(clusters):
            self.cluster_indices.append(np.concatenate(
                [np.arange(o, o + t) for (o, t) in clusters[c]]).astype(np.int32))
        self.max_dim = max(idx.size for idx in self.cluster_indices)
        C, m, f_size = len(self.cluster_indices), self.max_dim, pm.f_size
        G = np.full((C, m), f_size, np.int32)
        M = np.zeros((C, m), np.float64)
        for ci, idx in enumerate(self.cluster_indices):
            G[ci, :idx.size] = idx
            M[ci, :idx.size] = 1.0
        self.gather, self.mask = G, M
        # each tangent index's cluster and place in it (the pad: cluster C)
        self.loc_cluster = np.full(f_size + 1, C, np.int64)
        self.loc_offset = np.zeros(f_size + 1, np.int64)
        for ci, idx in enumerate(self.cluster_indices):
            self.loc_cluster[idx] = ci
            self.loc_offset[idx] = np.arange(idx.size)
        self.parent_of = None
        if self.chains is not None:
            self.parent_of = np.full(C, -1, np.int64)
            K = max(len(ch) for ch in self.chains) if self.chains else 1
            cg = np.full((max(len(self.chains), 1), K), C, np.int64)
            for q, ch in enumerate(self.chains):
                for k, c in enumerate(ch):
                    cg[q, k] = c
                    if k:
                        self.parent_of[c] = ch[k - 1]
            self.chain_clusters = cg
        self._device_tables()

    def _device_tables(self):
        """The apply's gathers: each padded slot's tangent index (C*m,) and
        each tangent index's padded slot (f_size,), with the chains' own
        for CLUSTER_TRIDIAGONAL."""
        dev, f_size = self.device, self.pm.f_size
        C, m = len(self.cluster_indices), self.max_dim
        i32 = torch.int32
        self.gather_t = torch.as_tensor(self.gather.reshape(-1), dtype=i32, device=dev)
        self.mask_t = torch.as_tensor(self.mask, device=dev)
        pos = self.loc_cluster[:f_size] * m + self.loc_offset[:f_size]
        self.scatter_t = torch.as_tensor(pos, dtype=i32, device=dev)
        if self.chains is None:
            return
        cg = self.chain_clusters
        Q, K = cg.shape
        gp = np.concatenate([self.gather, np.full((1, m), f_size, np.int32)])
        self.chain_t = torch.as_tensor(cg, device=dev)
        # (K, Q, m) tangent index of each chain position's slot, and each
        # tangent index's slot in that (K, Q, m) layout
        self.chain_gather_t = torch.as_tensor(
            gp[cg].transpose(1, 0, 2).reshape(-1), dtype=i32, device=dev)
        kq = np.full((C, 2), 0, np.int64)
        for q in range(Q):
            for k in range(K):
                if cg[q, k] < C:
                    kq[cg[q, k]] = (k, q)
        cl = self.loc_cluster[:f_size]
        pos = (kq[cl, 0] * Q + kq[cl, 1]) * m + self.loc_offset[:f_size]
        self.chain_scatter_t = torch.as_tensor(pos, dtype=i32, device=dev)


def _gather(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v[idx] with idx == len(v) the zero pad, by kernel 7."""
    vp = torch.cat([v, v.new_zeros((1,))])
    return kn.segment_block_expand(vp[:, None].contiguous(), idx)[:, 0]


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky factors without a host sync; a factor that
    fails is NaN, as the JAX cholesky's."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


def make_cluster_preconditioner(cs: ClusterStructure, s_dense_blocks_fn: Callable):
    """The CLUSTER_JACOBI apply from the (C, m, m) blocks
    s_dense_blocks_fn() makes (identity on the padding): one batched
    Cholesky, then a batched Cholesky solve per apply, in the blocks'
    dtype; the result in v's."""
    L = _cholesky(s_dense_blocks_fn())
    C, m = L.shape[0], L.shape[1]

    def apply(v):
        seg = _gather(v, cs.gather_t).to(L.dtype).reshape(C, m, 1)
        sol = torch.cholesky_solve(seg, L)[..., 0] * cs.mask_t.to(L.dtype)
        return _gather(sol.reshape(-1), cs.scatter_t).to(v.dtype)

    return apply


def make_cluster_tridiagonal_preconditioner(cs: ClusterStructure, blocks_fn: Callable):
    """The exact CLUSTER_TRIDIAGONAL apply: a batched block-tridiagonal
    Cholesky along the cluster chains
    (visibility_based_preconditioner.cc:438-504), every chain factored in
    step along chain position, with forward and backward sweeps per apply.
    blocks_fn() -> (D, O): D (C, m, m) the diagonal cluster blocks (damped,
    identity on the padding), O (C, m, m) with O[c] = S[c, parent(c)] (zero
    for a chain's head). The restriction of an SPD matrix to a tridiagonal
    block pattern can be indefinite: where any factorization fails, the
    cluster-Jacobi factors of D take its place (decided on the device)."""
    D_blocks, O_blocks = blocks_fn()
    m = cs.max_dim
    cg = cs.chain_t
    Q, K = cg.shape
    dt, dev = D_blocks.dtype, D_blocks.device
    eye = torch.eye(m, dtype=dt, device=dev)
    Dp = torch.cat([D_blocks, eye[None]])
    Op = torch.cat([O_blocks, O_blocks.new_zeros((1, m, m))])
    Dc = Dp[cg].transpose(0, 1)  # (K, Q, m, m)
    Oc = Op[cg].transpose(0, 1)
    Ls, Xs = [], []
    L_prev = eye.expand(Q, m, m)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    for k in range(K):
        # L_{k,k-1} = O_k L_{k-1}^{-T}; O_k = 0 at heads and padding: X = 0
        Xk = torch.linalg.solve_triangular(L_prev, Oc[k].transpose(-1, -2),
                                           upper=False).transpose(-1, -2)
        Lk, info = torch.linalg.cholesky_ex(Dc[k] - Xk @ Xk.transpose(-1, -2))
        ok = ok & torch.all(info == 0)
        Ls.append(Lk)
        Xs.append(Xk)
        L_prev = Lk
    L, X = torch.stack(Ls), torch.stack(Xs)
    ok = ok & torch.isfinite(L).all() & torch.isfinite(X).all()
    L_jac = _cholesky(Dp)[cg].transpose(0, 1)
    L = torch.where(ok, L, L_jac)
    X = torch.where(ok, X, torch.zeros_like(X))
    X_next = torch.cat([X[1:], torch.zeros_like(X[:1])])
    M3 = (cs.chain_gather_t < cs.pm.f_size).to(dt).reshape(K, Q, m)

    def apply(v):
        b = _gather(v, cs.chain_gather_t).to(dt).reshape(K, Q, m)
        y = []
        y_prev = b.new_zeros((Q, m, 1))
        for k in range(K):
            r = b[k][..., None] - X[k] @ y_prev
            y_prev = torch.linalg.solve_triangular(L[k], r, upper=False)
            y.append(y_prev)
        xs = [None] * K
        x_next = b.new_zeros((Q, m, 1))
        for k in reversed(range(K)):
            r = y[k] - X_next[k].transpose(-1, -2) @ x_next
            x_next = torch.linalg.solve_triangular(L[k].transpose(-1, -2), r, upper=True)
            xs[k] = x_next
        x = torch.stack(xs)[..., 0] * M3
        return _gather(x.reshape(-1), cs.chain_scatter_t).to(v.dtype)

    return apply


class ClusterBlockAssembler:
    """The cluster blocks of S (and, for CLUSTER_TRIDIAGONAL, each
    cluster's block against its chain parent), planned once: the products
    of the camera pairs within a cluster (or between a cluster and its
    parent) through sparse_schur.SchurPairs, their pair sums by kernel 6,
    and for each slot of the (C, m, m) layout the pair-sum entry that fills
    it (the pad, zero), gathered by kernel 7."""

    def __init__(self, pm: pt.PartitionedMeta, cs: ClusterStructure, flat: fo.FlatSchurOps):
        self.pm, self.cs, self.flat = pm, cs, flat
        C, m = len(cs.cluster_indices), cs.max_dim
        self.C, self.m = C, m
        self.tridiagonal = cs.chains is not None
        parent_p = np.full(C + 1, -2, np.int64)  # -2 matches no cluster
        if self.tridiagonal:
            parent_p[:C] = cs.parent_of
        loc_c = cs.loc_cluster

        def keep(fa, la, fb, lb):
            (off_a, _, ta, _), (off_b, _, tb, _) = pm.f_fams[fa], pm.f_fams[fb]
            ca, cb = loc_c[off_a + la * ta], loc_c[off_b + lb * tb]
            return ((ca == cb) & (ca < C)) | (parent_p[ca] == cb)

        self.pairs = SchurPairs(pm, flat, keep)
        self.plan = PairSumPlan(self.pairs.specs, flat.device)
        rows, cols = self.plan.rows, self.plan.cols
        c1, c2 = loc_c[rows], loc_c[cols]
        dest = c1 * m * m + cs.loc_offset[rows] * m + cs.loc_offset[cols]
        n = rows.size

        def src_of(hit):
            src = np.full(C * m * m, n, np.int32)  # the zero pad
            src[dest[hit]] = np.flatnonzero(hit)
            return torch.as_tensor(src, device=flat.device)

        self.src_d = src_of((c1 == c2) & (c1 < C))
        self.src_o = src_of(parent_p[c1] == c2) if self.tridiagonal else None

    def __call__(self, vflat, D_e: torch.Tensor, D_f: torch.Tensor):
        """(C, m, m) blocks of S + D_f^2, identity on the padding, made
        symmetric, in float64; with the (C, m, m) parent blocks for
        CLUSTER_TRIDIAGONAL. vflat: the (scaled) Jacobian blocks (B, r*t)."""
        pm, fl, cs = self.pm, self.flat, self.cs
        C, m = self.C, self.m
        vflat = tuple(tuple(V.to(_F64) for V in jacs) for jacs in vflat)
        minv = fl.inverse_flats(pm.e_fams, fl.block_ete(vflat), D_e.to(_F64))
        sums = self.plan.sums(self.pairs.products(vflat, minv))
        sums = torch.cat([sums, sums.new_zeros((1,))])[:, None].contiguous()
        blocks = kn.segment_block_expand(sums, self.src_d).reshape(C, m, m)
        M = cs.mask_t
        dseg = _gather(D_f.to(_F64), cs.gather_t).reshape(C, m)
        blocks = blocks + torch.diag_embed(dseg * dseg * M + (1.0 - M))
        blocks = 0.5 * (blocks + blocks.transpose(1, 2))
        if self.tridiagonal:
            return blocks, kn.segment_block_expand(sums, self.src_o).reshape(C, m, m)
        return blocks


def build_cluster(pm: pt.PartitionedMeta, flat: fo.FlatSchurOps, clustering_type,
                  tridiagonal: bool):
    """The visibility clustering of the f blocks (cameras) and the block
    assembler (the JAX bsr_kernels._build_cluster,
    visibility_based_preconditioner.cc:127-322): the camera-camera graph of
    shared points, CANONICAL_VIEWS or SINGLE_LINKAGE clusters, and for
    CLUSTER_TRIDIAGONAL the degree-2 maximum spanning forest over them.
    Returns (ClusterStructure, ClusterBlockAssembler); the structure's
    `host_seconds` is the time the graph and the clustering took."""
    from ...utils import clustering

    t0 = time.perf_counter()
    pts, cams = [], []
    num_f = sum(nv for (_, nv, _, _) in pm.f_fams)
    num_e = sum(nv for (_, nv, _, _) in pm.e_fams)
    # each kind's e-block ids and its f slots' block ids, in the partitions'
    # block numbering (num_e, num_f for a constant block), kinds and slots
    # in order, as the JAX function reads them
    e_ids = {k: pm.e_fams[fi][3] + np.where(local < pm.e_fams[fi][1], local, num_e)
             for k, _, fi, local in pt.slot_layouts(pm, True)}
    for k, _, fi, local in pt.slot_layouts(pm, False):
        if k not in e_ids:
            continue
        eb = e_ids[k]
        fb = pm.f_fams[fi][3] + np.where(local < pm.f_fams[fi][1], local, num_f)
        ok = (eb < num_e) & (fb < num_f)
        pts.append(eb[ok])
        cams.append(fb[ok])
    point_ids = np.concatenate(pts) if pts else np.zeros(0, np.int32)
    camera_ids = np.concatenate(cams) if cams else np.zeros(0, np.int32)
    edges = clustering.compute_visibility_graph(point_ids, camera_ids, num_f)
    if clustering_type.name == "SINGLE_LINKAGE":
        membership = clustering.single_linkage_clustering(num_f, edges)
    else:
        membership = clustering.canonical_views_clustering(num_f, edges)
    forest = None
    if tridiagonal:
        forest = clustering.maximum_spanning_forest_degree2(num_f, edges, membership)
    cs = ClusterStructure(pm, membership, forest, flat.device)
    cs.host_seconds = time.perf_counter() - t0
    STATS.update(clusters=len(cs.cluster_indices), largest_m=cs.max_dim,
                 chains=len(cs.chains or []),
                 forest_edges=0 if forest is None else len(forest),
                 host_seconds=cs.host_seconds)
    return cs, ClusterBlockAssembler(pm, cs, flat)


class SubsetPreconditioner:
    """(Q'Q + D^2)^{-1}, Q the rows of J of the selected residual blocks:
    Q'Q + D^2 formed on the device over the whole J'J pattern (the rows
    outside the subset zeroed), factored by the native sparse Cholesky at
    each step, applied on the host. Where the factorization fails, the
    apply is the identity, as the JAX class's."""

    def __init__(self, meta, device, kind_mask: Sequence[bool]):
        self.meta = meta
        self.ipc = InnerProductComputer(meta, device, kind_mask=list(kind_mask))
        self.chol = native.SparseCholesky(self.ipc.n, self.ipc.indptr, self.ipc.indices)
        self._ok = False

    def update(self, vflat_masked, D: torch.Tensor, to_host: Callable) -> bool:
        vals_t = self.ipc.compute(vflat_masked, D)
        (vals,) = to_host(vals_t)
        native.STATS["dtoh_bytes"] += vals_t.nbytes
        self._ok = self.chol.factorize(vals)
        return self._ok

    def make_apply(self, to_host: Callable) -> Callable:
        """v -> (Q'Q + D^2)^{-1} v for a device vector v: v to the host and
        back, one counted sync."""
        if not self._ok:
            return lambda v: v

        def apply(v):
            (vh,) = to_host(v)
            native.STATS["dtoh_bytes"] += v.nbytes
            return torch.as_tensor(self.chol.solve(vh), device=v.device).to(v.dtype)

        return apply
