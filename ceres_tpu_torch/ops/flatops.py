"""The Schur operations over flat tensors (counterpart of
ceres_tpu/ops/flatops.py), in its two halves.

The jt half (`JTSchurOps`) serves the programs the fused jt-mode path
takes (`jt_refusal`): one kind of a Snavely residual the eval_fused kernel
computes, over one camera family (angle-axis, or quaternion under its
manifold) and one point family, with no loss or a built-in one (BAL).
The JAX module plans 128-lane row tiles, gather bases,
camera windows and streamed mask planes to satisfy TPU alignment; none of
that carries over. What its CUDA kernels need instead is the row plan
(`RowPlan`): rows sorted by point with the point segments and blocks, and
the camera plans (the rows ordered by camera, cut into chunks that never
cross a camera; the runs of one camera within a tile of rows; their trees
of levels). Only the dense Schur assembly also needs the point-pair plan,
which holds each pair of two rows of one point once, by camera-pair key,
and a tree of levels over the C(C+1)/2 keys: it is built on request
(`RowPlan.ensure_pairs`), never for the iterative path, whose camera count
can make it gigabytes.

The flat half (`FlatSchurOps`) serves every other program (the libmv
bundle adjuster, costs with another residual, a user's own loss, other
manifolds, several kinds or e/f families): products and reductions over
per-(kind, slot) Jacobian blocks flattened to (B, r*t), one `SlotPlanFlat` per slot. The JAX module's 0/1
selector matmuls are an MXU device; here they are reshapes and batched
products on (B, r, t) views. Its reductions take two tiers, not five:
sorted ids go to segment_block_sum (kernel 6), unsorted ids to
unsorted_segment_sum (kernel 9), at every family size and in both dtypes,
through a `SegmentPlan`; every gather goes to segment_block_expand
(kernel 7).

Every plan is structure-constant, built once per compiled program with
numpy and moved to the device.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import kernels as kn
from . import partition as pt


# --------------------------------------------------------------------------
# The row plan
# --------------------------------------------------------------------------


@dataclasses.dataclass
class PairPlan:
    """The dense Schur assembly's pairs (csrc/schur_assembly.cu): each pair
    of two rows of one point once, a from the lower camera (the earlier row
    within one camera), ordered by the key of its camera pair (c_a <= c_b:
    the upper triangle of the C x C blocks, row by row), then by point. A
    row's product with itself is a sum by camera, which the kernel takes
    with FtF's."""

    pair_a: torch.Tensor  # (NP,) int32 rows; (a, b) share a point
    pair_b: torch.Tensor
    # the fixed tree of the sum by keys: level 0 cuts each key's pairs into
    # chunks of at most kn.CHUNK, each further level a key's partials of the
    # level before; pair_level_first (n_keys+1,) int32 indexes each key's
    # chunks of the last level
    pair_levels: Tuple[torch.Tensor, ...]
    pair_level_first: torch.Tensor
    key_cams: torch.Tensor  # (n_keys,) int32 c_a * C + c_b of each key

    def __post_init__(self):
        (self.pair_level_sizes, self.pair_level_counts,
         self.pair_level_ptrs) = level_host_arrays(self.pair_levels, "pairs.pair_levels",
                                                   self.pair_a.device)

    @property
    def n_keys(self) -> int:
        return self.key_cams.shape[0]


@dataclasses.dataclass
class RowPlan:
    """The rows of a program the jt kernels take, sorted by point, and
    their camera plans. A row whose camera id is C or more is a row of a
    constant camera (the sentinel): eval_fused reads that camera's row of
    the camera table (n_cams rows), the point passes take the row, and no
    camera pass does: it has no place in camera order (cam_pos -1), it
    belongs to no run that reaches a camera (run_pos -1), and no pair of
    the pair plan holds it."""

    B: int
    P: int
    C: int
    pt_idx: torch.Tensor  # (B,) int32, nondecreasing
    cam_idx: torch.Tensor  # (B,) int32, in [0, n_cams); C and above: constant
    pt_start: torch.Tensor  # (P+1,) int32: rows of point p are [p], [p+1])
    cam_rows: torch.Tensor  # (B,) int32: rows ordered by camera (stable), sentinel last
    cam_chunk_start: torch.Tensor  # (n+1,) int32 offsets into cam_rows
    cam_pos: torch.Tensor  # (B,) int32: each row's place in cam_rows, -1 for the sentinel
    # the fixed tree of a camera sum over rows in camera order: level 0 is
    # cam_chunk_start, each further level chunks a camera's partials of the
    # level before (SegmentPlan.level_starts); cam_level_first (C+1,) int32
    # indexes each camera's chunks of the last level
    cam_levels: Tuple[torch.Tensor, ...]
    cam_level_first: torch.Tensor
    # (n+1,) int32 first point of each point block: whole points of at most
    # kn.POINT_BLOCK rows and points together, or one point of more rows
    pt_block: torch.Tensor
    # the runs: the rows of one camera within one tile, a tile being a point
    # block's rows, or kn.POINT_BLOCK of them in a block of one longer point
    # (post_eval_fused, schur_jacobi_blocks and schur_assembly sum their
    # camera values over each run first)
    tile_first: torch.Tensor  # (n_pt_blocks+1,) int32 first tile of each point block
    tile_run: torch.Tensor  # (n_tiles+1,) int32 first run of each tile
    # the rows in run order, (tile, camera, row): run q holds the places
    # run_start[q] .. run_start[q+1], row b sits at place run_slot[b]
    run_start: torch.Tensor  # (n_runs+1,) int32
    run_slot: torch.Tensor  # (B,) int32
    run_pos: torch.Tensor  # (n_runs,) int32 each run's place in camera order, or -1
    # the camera sum's tree over the runs in camera order, as cam_levels
    run_levels: Tuple[torch.Tensor, ...]
    run_level_first: torch.Tensor
    n_cams: int  # rows of the camera table eval_fused reads, at least C
    pairs: Optional[PairPlan] = None  # the dense-Schur pair plan, on request

    def __post_init__(self):
        if self.n_cams < self.C:
            raise ValueError(f"a camera table of {self.n_cams} rows for {self.C} cameras")
        # the levels as the kernels pass them, checked and built once: their
        # chunk counts, and host arrays of those counts and of the levels'
        # device pointers
        dev = self.cam_idx.device
        (self.cam_level_sizes, self.cam_level_counts,
         self.cam_level_ptrs) = level_host_arrays(self.cam_levels, "cam_levels", dev)
        (self.run_level_sizes, self.run_level_counts,
         self.run_level_ptrs) = level_host_arrays(self.run_levels, "run_levels", dev)

    @property
    def n_pt_blocks(self) -> int:
        return self.pt_block.shape[0] - 1

    @property
    def n_tiles(self) -> int:
        return self.tile_run.shape[0] - 1

    @property
    def n_runs(self) -> int:
        return self.run_pos.shape[0]

    def ensure_pairs(self) -> PairPlan:
        """The point-pair plan, built on first request."""
        if self.pairs is None:
            self.pairs = _build_pair_plan(self.pt_idx.cpu().numpy(),
                                          self.cam_idx.cpu().numpy(),
                                          self.pt_start.cpu().numpy(), self.C,
                                          self.pt_idx.device)
        return self.pairs


def level_host_arrays(levels, name: str, device):
    """(sizes, counts, ptrs) of a fixed summation tree's levels, each an
    int32 (n + 1,) tensor of chunk offsets on `device`: the chunk counts,
    and host arrays of those counts and of the levels' device pointers, as
    the kernels take them. Raises for a level that is not such a tensor."""
    for lv, st in enumerate(levels):
        kn._check(st, f"plan.{name}[{lv}]", torch.int32, (st.shape[0],), device)
    sizes = tuple(int(st.shape[0]) - 1 for st in levels)
    n = len(levels)
    return (sizes, (ctypes.c_int * n)(*sizes),
            (ctypes.c_void_p * n)(*[st.data_ptr() for st in levels]))


def _chunks(keys_sorted: np.ndarray, num_keys: int, chunk: int):
    """Chunk offsets over a key-sorted list: each key's run is cut into
    pieces of at most `chunk` items. Returns (chunk_start (n+1,),
    chunk_first (num_keys+1,)), int64."""
    return _chunks_of_counts(np.bincount(keys_sorted, minlength=num_keys), chunk)


def _chunks_of_counts(counts: np.ndarray, chunk: int):
    """_chunks from the number of items of each key."""
    counts = np.asarray(counts, np.int64)
    num_keys = counts.shape[0]
    per_key = -(-counts // chunk)
    chunk_first = np.concatenate([[0], np.cumsum(per_key)])
    key_start = np.concatenate([[0], np.cumsum(counts)])
    n = int(chunk_first[-1])
    owner = np.repeat(np.arange(num_keys, dtype=np.int64), per_key)
    j = np.arange(n, dtype=np.int64) - chunk_first[owner]
    starts = key_start[owner] + j * chunk
    chunk_start = np.concatenate([starts, [key_start[-1]]])
    return chunk_start, chunk_first


def _chunk_levels(counts: np.ndarray):
    """The chunk offsets of each level of a fixed summation tree over keys
    with `counts` items each (in key order): level 0 cuts each key's items
    into chunks of at most CHUNK, and while a key still owns more than
    CHUNK chunks, the next level cuts its chunk partials again. Returns
    the chunk_start and the chunk_first of each level, int64."""
    starts, firsts = [], []
    per_key = counts
    while True:
        chunk_start, chunk_first = _chunks_of_counts(per_key, kn.CHUNK)
        starts.append(chunk_start)
        firsts.append(chunk_first)
        per_key = np.diff(chunk_first)
        if per_key.max(initial=0) <= kn.CHUNK:
            return starts, firsts


def _point_blocks(pt_start: np.ndarray, cap: int) -> np.ndarray:
    """The first point of each point block, greedily: whole points while
    their rows and their number stay within `cap`, or one point of more
    rows alone. (n+1,) int64."""
    P = pt_start.shape[0] - 1
    first = np.arange(P, dtype=np.int64)
    # the furthest end of a block that starts at each point
    end = np.searchsorted(pt_start, pt_start[:-1] + cap, side="right") - 1
    end = np.maximum(np.minimum(end, first + cap), first + 1).tolist()
    blocks = [0]
    while blocks[-1] < P:
        blocks.append(end[blocks[-1]])
    return np.asarray(blocks, np.int64)


def _runs(tile, keys, key_rows, n_tiles: int, num_keys: int):
    """The runs of one key within one tile of rows, for each row's tile
    `tile` and key `keys` (B,) and the rows in key order, stable
    (`key_rows`): (tile_run, run_start, run_slot, run_pos, each run's key,
    counts of runs per key), int64. Runs are found in key order, along key_rows, where a
    key's rows come in row order and so tile by tile; then ordered by tile,
    key within a tile: the rows in run order, (tile, key, row), are the
    places run_start[q] .. run_start[q+1] of run q, row b at place
    run_slot[b]; run_pos[q] is run q's place among the runs in key order."""
    B = keys.shape[0]
    tile = tile[key_rows]
    key = keys[key_rows]
    new = np.ones(B, bool)
    new[1:] = (tile[1:] != tile[:-1]) | (key[1:] != key[:-1])
    first = np.flatnonzero(new)  # each run's first place in key order
    length = np.diff(np.append(first, B))
    order = np.argsort(tile[first], kind="stable")  # the runs by tile
    run_start = np.concatenate([[0], np.cumsum(length[order])]).astype(np.int64)
    run_slot = np.empty(B, np.int64)
    run_slot[key_rows[np.repeat(first[order] - run_start[:-1], length[order])
                      + np.arange(B)]] = np.arange(B)
    tile_run = np.concatenate([[0], np.cumsum(np.bincount(tile[first],
                                                          minlength=n_tiles))])
    return (tile_run, run_start, run_slot, order, key[first[order]],
            np.bincount(key[first], minlength=num_keys))


def _camera_runs(pt_start, pt_block, cam_idx, cam_rows, C: int):
    """The runs of one camera within one tile of rows (RowPlan.run_*):
    (tile_first, tile_run, run_start, run_slot, run_pos, counts of runs per
    camera), int64. A tile is a point block's rows, or kn.POINT_BLOCK of
    them in a block of one longer point. cam_idx holds C for the sentinel:
    its runs come last in each tile and in camera order, and their run_pos
    is -1."""
    cap = kn.POINT_BLOCK
    blk_rows = pt_start[pt_block]
    per_block = np.maximum(1, -(-np.diff(blk_rows) // cap))
    tile_first = np.concatenate([[0], np.cumsum(per_block)])
    owner = np.repeat(np.arange(per_block.shape[0]), per_block)
    t0 = blk_rows[owner] + (np.arange(tile_first[-1]) - tile_first[owner]) * cap
    t1 = np.minimum(t0 + cap, blk_rows[owner + 1])
    tile = np.repeat(np.arange(t0.shape[0]), t1 - t0)
    tile_run, run_start, run_slot, run_pos, run_key, per_cam = _runs(
        tile, cam_idx, cam_rows, t0.shape[0], C + 1)
    return (tile_first, tile_run, run_start, run_slot,
            np.where(run_key < C, run_pos, -1), per_cam[:C])


def _dev_i32(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.size and (a.min() < 0 or a.max() > np.iinfo(np.int32).max):
        raise ValueError("a plan index does not fit int32")
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)


def build_row_plan(pt_idx: np.ndarray, cam_idx: np.ndarray, P: int, C: int,
                   device, n_cams: int) -> RowPlan:
    """The row plan of rows sorted by point: pt_idx in [0, P), cam_idx in
    [0, n_cams), ids of C and above being rows of a constant camera
    (RowPlan)."""
    pt_idx = np.asarray(pt_idx, np.int64)
    cam_idx = np.asarray(cam_idx, np.int64)
    if np.any(pt_idx[1:] < pt_idx[:-1]):
        raise ValueError("the row plan needs rows sorted by point")
    if pt_idx.size and (pt_idx[0] < 0 or pt_idx[-1] >= P):
        raise ValueError("a row's point is out of range")
    if cam_idx.size and (cam_idx.min() < 0 or cam_idx.max() >= n_cams):
        raise ValueError("a row's camera is out of range")
    B = pt_idx.shape[0]
    counts = np.bincount(pt_idx, minlength=P)
    pt_start = np.concatenate([[0], np.cumsum(counts)])
    cam = np.minimum(cam_idx, C)  # the sentinel C sorts last
    cam_rows = np.argsort(cam, kind="stable")
    cam_pos = np.empty(B, np.int64)
    cam_pos[cam_rows] = np.arange(B)
    cam_pos[cam == C] = -1
    starts, firsts = _chunk_levels(np.bincount(cam, minlength=C + 1)[:C])

    def dev(a):
        return _dev_i32(a, device)

    cam_levels = tuple(dev(a) for a in starts)
    pt_block = _point_blocks(pt_start, kn.POINT_BLOCK)
    *runs, runs_per_cam = _camera_runs(pt_start, pt_block, cam, cam_rows, C)
    run_starts, run_firsts = _chunk_levels(runs_per_cam)

    def dev_signed(a):  # places of -1 for the sentinel
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)

    tile_first, tile_run, run_start, run_slot, run_pos = runs
    return RowPlan(B, P, C, dev(pt_idx), dev(cam_idx), dev(pt_start),
                   dev(cam_rows), cam_levels[0], dev_signed(cam_pos),
                   cam_levels, dev(firsts[-1]), dev(pt_block),
                   dev(tile_first), dev(tile_run), dev(run_start), dev(run_slot),
                   dev_signed(run_pos), tuple(dev(a) for a in run_starts),
                   dev(run_firsts[-1]), n_cams=n_cams)


def _build_pair_plan(pt_idx, cam_idx, pt_start, C: int, device) -> PairPlan:
    """Each pair (a, b) of two rows of one point once, a the row of the
    lower camera (the earlier row within one camera), ordered by
    camera-pair key and point, with the levels of its sum by key. A pair
    with a row of a constant camera (id C or above) is left out."""
    pt_idx = np.asarray(pt_idx, np.int64)
    cam_idx = np.asarray(cam_idx, np.int64)
    pt_start = np.asarray(pt_start, np.int64)
    B = pt_idx.shape[0]
    m = (pt_start[1:] - pt_start[:-1])[pt_idx]
    pair_a = np.repeat(np.arange(B, dtype=np.int64), m)
    first = np.concatenate([[0], np.cumsum(m)])[:-1]
    local = np.arange(pair_a.shape[0], dtype=np.int64) - np.repeat(first, m)
    pair_b = pt_start[pt_idx[pair_a]] + local
    ca, cb = cam_idx[pair_a], cam_idx[pair_b]
    keep = ((ca < cb) | ((ca == cb) & (pair_a < pair_b))) & (cb < C)
    pair_a, pair_b, ca, cb = pair_a[keep], pair_b[keep], ca[keep], cb[keep]
    # the row-by-row index of (ca, cb) in the upper triangle of C x C
    key = ca * C - ca * (ca - 1) // 2 + (cb - ca)
    order = np.argsort(key, kind="stable")
    rows, cols = np.triu_indices(C)
    starts, firsts = _chunk_levels(np.bincount(key, minlength=rows.shape[0]))

    def dev(a):
        return _dev_i32(a, device)

    return PairPlan(dev(pair_a[order]), dev(pair_b[order]), tuple(dev(a) for a in starts),
                    dev(firsts[-1]), dev(rows * C + cols))


# --------------------------------------------------------------------------
# Flat-lane block algebra
# --------------------------------------------------------------------------


def _chol3(M: torch.Tensor):
    """Closed-form Cholesky of SPD 3x3 blocks (N, 9) row-major, in float64:
    the small-pivot recurrences cancel badly in float32. Returns the
    inverse factor K = L^{-1} as its six lanes (K11, K21, K22, K31, K32,
    K33)."""
    m = M.to(torch.float64)
    a, b, c = m[:, 0], m[:, 1], m[:, 2]
    d, e, f = m[:, 4], m[:, 5], m[:, 8]
    L11 = torch.sqrt(a)
    L21 = b / L11
    L31 = c / L11
    L22 = torch.sqrt(d - L21 * L21)
    L32 = (e - L21 * L31) / L22
    L33 = torch.sqrt(f - L31 * L31 - L32 * L32)
    K11 = 1.0 / L11
    K22 = 1.0 / L22
    K33 = 1.0 / L33
    K21 = -L21 * K11 * K22
    K31 = (L21 * L32 - L31 * L22) * K11 * K22 * K33
    K32 = -L32 * K22 * K33
    return K11, K21, K22, K31, K32, K33


def chol_inv_lower_flat(M: torch.Tensor, t: int) -> torch.Tensor:
    """K = L^{-1} (lower triangular, upper entries zero) of SPD blocks
    stored as (N, t*t) row-major rows; closed form for t = 3, a batched
    Cholesky and triangular solve otherwise (flatops.py:215-221). A block
    that is not positive definite comes out NaN, without a host sync."""
    if t == 3:
        K11, K21, K22, K31, K32, K33 = _chol3(M)
        z = torch.zeros_like(K11)
        return torch.stack([K11, z, z, K21, K22, z, K31, K32, K33],
                           dim=1).to(M.dtype)
    N = M.shape[0]
    L, info = torch.linalg.cholesky_ex(M.reshape(N, t, t))
    L = torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))
    eye = torch.eye(t, dtype=M.dtype, device=M.device).expand(N, t, t)
    return torch.linalg.solve_triangular(L, eye, upper=False).reshape(N, t * t)


def spd_inverse_flat(M: torch.Tensor, t: int) -> torch.Tensor:
    """Inverses of SPD (t x t) blocks stored as (N, t*t) row-major rows
    (flatops.py:132). t = 3 in closed form, M^{-1} = K'K; larger t through
    a batched Cholesky (the JAX function is XLA there too). A block that is
    not positive definite comes out NaN, without a host sync, and the LM
    loop reads the step as invalid."""
    if t == 3:
        K11, K21, K22, K31, K32, K33 = _chol3(M)
        i11 = K11 * K11 + K21 * K21 + K31 * K31
        i12 = K21 * K22 + K31 * K32
        i13 = K31 * K33
        i22 = K22 * K22 + K32 * K32
        i23 = K32 * K33
        i33 = K33 * K33
        return torch.stack([i11, i12, i13, i12, i22, i23, i13, i23, i33],
                           dim=1).to(M.dtype)
    N = M.shape[0]
    L, info = torch.linalg.cholesky_ex(M.reshape(N, t, t))
    L = torch.where((info == 0)[:, None, None], L, torch.full_like(L, float("nan")))
    eye = torch.eye(t, dtype=M.dtype, device=M.device).expand(N, t, t)
    K = torch.linalg.solve_triangular(L, eye, upper=False)
    return (K.transpose(1, 2) @ K).reshape(N, t * t)


def small_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for batches of small blocks, A (N, a, k) and B (N, k, b), as k
    elementwise outer products: cuBLAS takes several times longer over a
    batch of blocks this small than their bytes need."""
    out = A[:, :, 0, None] * B[:, None, 0, :]
    for i in range(1, A.shape[2]):
        out = out + A[:, :, i, None] * B[:, None, i, :]
    return out


def scaled_blocks(blocks: torch.Tensor, scale: torch.Tensor, D2: torch.Tensor,
                  t: int) -> torch.Tensor:
    """S_b (J'J)_b S_b + diag(D2)_b per block: blocks (N, t*t), scale and
    D2 (N*t,) in the partition layout."""
    N = blocks.shape[0]
    s = scale.reshape(N, t)
    M = blocks * (s[:, :, None] * s[:, None, :]).reshape(N, t * t)
    return M + torch.diag_embed(D2.reshape(N, t)).reshape(N, t * t)


def scaled_block_inverses(blocks: torch.Tensor, scale: torch.Tensor,
                          D2: torch.Tensor, t: int) -> torch.Tensor:
    """Inverses of S_b (J'J)_b S_b + diag(D2)_b per block (flatops.py:633)."""
    return spd_inverse_flat(scaled_blocks(blocks, scale, D2, t), t)


def apply_inverse_rows(inv: torch.Tensor, v: torch.Tensor, t: int) -> torch.Tensor:
    """x = blockdiag^{-1} v from inverse blocks (N, t*t) (flatops.py:648)."""
    N = inv.shape[0]
    return small_matmul(inv.reshape(N, t, t), v.reshape(N, t, 1)).reshape(-1)


class JTQual(NamedTuple):
    """What qualifies a program for the fused jt-mode evaluation: its
    camera (f) and point (e) families, the residual (`rows_fn`, the
    kernel's model), the camera's ambient width and the loss flattened
    for the kernel."""

    fam_f: object
    fam_e: object
    rows_fn: object
    cam_size: int
    loss: object  # loss.LossChain


def jt_refusal(pm: pt.PartitionedMeta, program, options=None) -> Optional[str]:
    """Why the fused jt-mode path does not take this program, or None
    when it does. It takes what the eval_fused kernel computes, on either
    device alike: one kind of two slots, one point (e) and one camera (f)
    family of tangent sizes 3 and 9, rows sorted by point, every point
    variable (a constant camera is the row plan's sentinel), (B, 2)
    observations, and
      - the residual snavely_residual_rows with Euclidean cameras (9) and
        points (3), or snavely_quat_residual_rows with cameras of 10 under
        ProductManifold(QuaternionManifold(), EuclideanManifold(6)) and
        Euclidean points;
      - no loss, TrivialLoss, or a loss that loss.flatten_loss reduces to
        the kernel's chain.
    With `options`, use_mixed_precision_solves is refused too: the mixed
    dense-Schur step refines through the flat products, as the JAX loop's
    does (fused_lm.py:295, :628, :982).
    Every other program takes the flat path: a user's own residual_rows,
    a user LossFunction subclass, any other manifold (the JAX
    qualification of flatops.py:685-710 and :842-894, without its float32
    condition: the kernels take both dtypes, and without its tracing of
    any rows_fn, which a hand-written kernel cannot do)."""
    from ..loss import flatten_loss
    from ..models.bal import quaternion_camera_manifold

    kinds = pm.base.kinds
    if len(kinds) != 1 or len(kinds[0].slots) != 2:
        return "not one residual kind of two slots"
    if len(pm.e_fams) != 1 or len(pm.f_fams) != 1:
        return "more than one e or f family"
    kind, pkind = kinds[0], program.kinds[0]
    fe = pm.base.families[pm.e_family_indices[0]]
    ff = pm.base.families[pm.f_family_indices[0]]
    if (kind.r, ff.t, fe.t) != (kn.R, kn.TF, kn.TE):
        return f"residual/camera/point sizes {(kind.r, ff.t, fe.t)}"
    e_ids = next(s.block_ids for s in kind.slots
                 if s.family_index == pm.e_family_indices[0])
    if np.any(e_ids[1:] < e_ids[:-1]):
        return "rows not sorted by point"
    if np.any(e_ids - fe.block_id_offset >= fe.num_var):
        return "a constant point block"
    if options is not None and options.use_mixed_precision_solves:
        return "mixed-precision solves"
    pff = program.families[pm.f_family_indices[0]]
    pfe = program.families[pm.e_family_indices[0]]
    model = kn.eval_model(getattr(pkind.cost, "residual_rows", None))
    if model is None:
        return "a cost without the residual_rows of a kernel model"
    if not pfe.euclidean:
        return "a point manifold"
    if model == kn.MODEL_SNAVELY and not (pff.asize == kn.TF and pff.euclidean):
        return "angle-axis cameras that are not Euclidean of 9"
    if model == kn.MODEL_SNAVELY_QUAT and not (
            pff.asize == kn.TF + 1 and pff.manifold is not None and
            pff.manifold.batch_key() == quaternion_camera_manifold().batch_key()):
        return "quaternion cameras not of 10 under the quaternion camera manifold"
    if flatten_loss(pkind.loss) is None:
        return "a loss the kernel's loss chain does not take"
    if (not isinstance(pkind.data, torch.Tensor)
            or tuple(pkind.data.shape) != (pkind.B, kn.R)):
        return "observation data other than (B, 2)"
    return None


class JTSchurOps:
    """The e/f partition of a program the jt path takes (BA: cameras f,
    points e, `jt_refusal` is None), and its kernel plan. The row plan
    built here plays the part of the JAX `eval_invariants`
    (flatops.py:901): the structure-constant tensors the kernels read,
    built once; the observations stay in the program's kind data."""

    def __init__(self, pm: pt.PartitionedMeta, program):
        why = jt_refusal(pm, program)
        if why is not None:
            raise ValueError(f"the jt path does not take this program: {why}")
        self.pm = pm
        kind = pm.base.kinds[0]
        e_fi, f_fi = pm.e_family_indices[0], pm.f_family_indices[0]
        self.se = next(i for i, s in enumerate(kind.slots) if s.family_index == e_fi)
        self.sf = next(i for i, s in enumerate(kind.slots) if s.family_index == f_fi)
        fe, ff = pm.base.families[e_fi], pm.base.families[f_fi]
        pt_local = kind.slots[self.se].block_ids - fe.block_id_offset
        # each row's row of the camera table: a constant camera's is C or
        # more, the row plan's sentinel
        cam_slot = program.kinds[0].slots[self.sf]
        self.P, self.C = fe.num_var, ff.num_var
        self.plan = build_row_plan(pt_local, cam_slot.pos_in_family, self.P, self.C,
                                   program.device, n_cams=cam_slot.family.count)

    # -- evaluation (pallas_kernels.eval_fused) ----------------------------

    def eval_kernel_qual(self, program) -> JTQual:
        """The fused evaluation's families, residual and loss (jt_refusal
        has admitted them)."""
        from ..loss import flatten_loss

        kind = program.kinds[0]
        fam_f = kind.slots[self.sf].family
        return JTQual(fam_f, kind.slots[self.se].family, kind.cost.residual_rows,
                      fam_f.asize, flatten_loss(kind.loss))

    def eval_fused_x(self, program, q: JTQual, x: torch.Tensor):
        """Fused evaluation at state x: (cost f64 0-d, rT (2, B), JT (24, B)),
        the camera table (its constant cameras too) read at its ambient
        width, the Jacobian lanes in tangent coordinates, residuals and
        lanes corrected for the loss."""
        dt = program.compute_dtype
        cams = program.family_table(x, q.fam_f).to(dt).contiguous()
        pts = program.family_table(x, q.fam_e).to(dt).contiguous()
        kind = program.kinds[0]
        sq, rT, JT = kn.eval_fused(cams, pts, kind.data, self.plan, q.rows_fn,
                                   q.loss)
        cost = 0.5 * sq[0] + program.fixed_cost
        return cost, rT, JT

    # -- post evaluation (pallas_kernels.post_eval_fused) ------------------

    def post_eval_kernel_jt(self, JT, rT):
        """(g_e, sqn_e, ete (P, 9), g_f, sqn_f) in partition layouts."""
        ptab, cam = kn.post_eval_fused(JT, rT, self.plan)
        te, tf = kn.TE, kn.TF
        g_e = ptab[:, :te].reshape(-1)
        sqn_e = ptab[:, te:2 * te].reshape(-1)
        ete = ptab[:, 2 * te:]
        g_f = cam[:, :tf].reshape(-1)
        sqn_f = cam[:, tf:].reshape(-1)
        return g_e, sqn_e, ete, g_f, sqn_f

    # -- the kernel suite (flatops.py:1014) ---------------------------------

    def make_kernel_suite_raw(self, JT, se, sf):
        """Scale-folded kernels over the unscaled JT: the Jacobi scales fold
        into the small operands (flatops.py:1014-1026):

          matvec:  S_s z = sf (.) F'(fz - E u'),  fz = F (sf (.) z),
                   u' = [se Minv_s se] E'fz      (fold_minv makes the fold)
          SJ:      blocks_s[c] = sf_c (x) sf_c (.) (F'F - W' Minv_s W)
                   with W = diag(se) E'F, plus D_f^2, inverted
          normal:  J_s'J_s x through pre-scaled inputs, post-scaled outputs

        Returns (matvec, jacobi_blocks, normal, fold_minv) over vectors in
        scaled coordinates: matvec(z, minv_folded, emit_u) -> (S z without
        its D_f^2 term (C*9,), u = Minv_s E_s'F_s z (P*3,) or None);
        jacobi_blocks(minv, d2f) -> (C, 81) inverses of the blocks of S;
        normal(xc, xp_rows) -> (F_s'J_s x (C*9,), E_s'J_s x (P, 3))."""
        P, C, te, tf = self.P, self.C, kn.TE, kn.TF
        se_rows = se.reshape(P, te)
        sf_rows = sf.reshape(C, tf)

        def fold_minv(minv):
            return (minv * (se_rows[:, :, None] * se_rows[:, None, :]).reshape(
                P, te * te)).contiguous()

        def matvec(z, minv_folded, emit_u=False):
            cam, u = kn.isc_matvec(JT, (sf_rows * z.reshape(C, tf)).contiguous(),
                                   minv_folded, self.plan, emit_u)
            cam = (sf_rows * cam).reshape(-1)
            return cam, (u / se_rows).reshape(-1) if emit_u else None

        def jacobi_blocks(minv, d2f):
            blocks = kn.schur_jacobi_blocks(JT, se_rows.contiguous(),
                                            minv.contiguous(), self.plan)
            blocks = blocks * (sf_rows[:, :, None] * sf_rows[:, None, :]).reshape(
                C, tf * tf)
            M = blocks + torch.diag_embed(d2f.reshape(C, tf)).reshape(C, tf * tf)
            return spd_inverse_flat(M, tf)

        def normal(xc, xp_rows):
            cam, ptv = kn.normal_matvec(
                JT, (sf_rows * xc.reshape(C, tf)).contiguous(),
                (xp_rows * se_rows).contiguous(), self.plan)
            return (sf_rows * cam).reshape(-1), ptv * se_rows

        return matvec, jacobi_blocks, normal, fold_minv


# --------------------------------------------------------------------------
# The flat half: per-(kind, slot) plans and the products over them
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SegmentPlan:
    """The reduction plan of one slot's row -> block ids, for
    segment_block_sum (sorted ids, kernel 6) and unsorted_segment_sum
    (kernel 9), csrc/segment_sum.cu.

    The chunks by key: each key's rows in key order (through `order` when
    the ids are unsorted) cut into chunks of at most CHUNK rows; while a key
    still owns more than CHUNK chunks, the next level cuts its chunk
    partials again, so that a key holding every row (the shared intrinsics
    block) is summed in a fixed tree, never by one thread. key_first
    indexes each key's chunks of the last level, which the last pass sums
    in order. unsorted_segment_sum gathers through them.

    The runs (sorted ids, segment_block_sum): the rows cut into tiles of
    kn.SEG_TILE consecutive rows. A key whose rows end at most kn.SEG_HALO
    rows past the end of the tile of its first row is one run of that
    tile; a longer key has a run in each tile its rows meet. Runs are
    contiguous and in row order. A key of one run writes its sum straight
    to the output: its run_dest is n_partials + its key. The runs of every
    other key of rows write partials, in key order (run_dest < n_partials),
    summed by the same kind of tree (run_levels) and the last run level's
    chunks of each fin key (fin_first; fin_keys are the keys of several
    runs). Where no key has more than CHUNK partials there are no run
    levels: fin_first indexes the partials, which the last pass sums. The
    keys of no row (empty_keys) are zero.

    The levels' chunk counts and their host arrays (level_sizes,
    level_counts, level_ptrs; run_level_*) are checked and built once, with
    the plan."""

    ids: torch.Tensor  # (B,) int32 block id of each row, in [0, num_keys)
    num_keys: int
    order: Optional[torch.Tensor]  # (B,) int32 rows by key (stable); None if sorted
    level_starts: Tuple[torch.Tensor, ...]  # per level (n_l + 1,) int32 chunk offsets
    key_first: torch.Tensor  # (num_keys + 1,) int32 first last-level chunk of each key
    seg_start: Optional[torch.Tensor]  # sorted ids: (num_keys + 1,) int32 row offsets
    # the runs, for sorted ids (None, and () for unsorted)
    tile_run: Optional[torch.Tensor] = None  # (n_tiles + 1,) int32 first run of each tile
    run_start: Optional[torch.Tensor] = None  # (n_runs + 1,) int32 first row of each run
    run_dest: Optional[torch.Tensor] = None  # (n_runs,) int32 its partial, or n_partials + key
    n_partials: int = 0
    empty_keys: Optional[torch.Tensor] = None  # (n_empty,) int32 the keys of no row
    run_levels: Tuple[torch.Tensor, ...] = ()  # per level (n_l + 1,) int32, over the partials
    fin_first: Optional[torch.Tensor] = None  # (n_fin + 1,) int32 each fin key's chunks,
    # or partials where there are no run levels
    fin_keys: Optional[torch.Tensor] = None  # (n_fin,) int32 the keys of several runs

    def __post_init__(self):
        dev = self.ids.device
        (self.level_sizes, self.level_counts,
         self.level_ptrs) = level_host_arrays(self.level_starts, "level_starts", dev)
        (self.run_level_sizes, self.run_level_counts,
         self.run_level_ptrs) = level_host_arrays(self.run_levels, "run_levels", dev)

    @property
    def B(self) -> int:
        return self.ids.shape[0]

    @property
    def n_runs(self) -> int:
        return self.run_dest.shape[0]

    @property
    def n_fin(self) -> int:
        return self.fin_keys.shape[0]

    @property
    def n_empty(self) -> int:
        return self.empty_keys.shape[0]


def _segment_runs(ids: np.ndarray, num_keys: int):
    """The runs of SegmentPlan for sorted ids: (tile_run, run_start,
    run_dest, n_partials, empty_keys, run level starts, fin_first,
    fin_keys)."""
    B = ids.shape[0]
    T = kn.SEG_TILE
    counts = np.bincount(ids, minlength=num_keys)
    start = np.concatenate([[0], np.cumsum(counts)])
    # each row's tile for the runs: the tile of its key's first row where
    # the key ends within SEG_HALO rows past that tile, else its own
    whole = start[1:] <= (start[:-1] // T + 1) * T + kn.SEG_HALO
    rows = np.arange(B, dtype=np.int64)
    tile = np.where(whole[ids], start[ids] // T, rows // T)
    tile_run, run_start, _, _, _, per_key = _runs(tile, ids, rows, -(-B // T), num_keys)
    # the runs (in key order, as the rows): each one's key, and its partial
    # where its key has several runs
    run_key = np.repeat(np.arange(num_keys, dtype=np.int64), per_key)
    several = per_key[run_key] > 1
    n_partials = int(several.sum())
    dest = np.where(several, np.cumsum(several) - 1, n_partials + run_key)
    empty_keys = np.flatnonzero(per_key == 0)
    fin_keys = np.flatnonzero(per_key > 1)
    counts = per_key[fin_keys]
    if counts.max(initial=0) <= kn.CHUNK:  # the last pass sums the partials themselves
        return (tile_run, run_start, dest, n_partials, empty_keys, [],
                np.concatenate([[0], np.cumsum(counts)]), fin_keys)
    starts, firsts = _chunk_levels(counts)
    return (tile_run, run_start, dest, n_partials, empty_keys, starts, firsts[-1],
            fin_keys)


def build_segment_plan(ids, num_keys: int, device) -> SegmentPlan:
    ids = np.asarray(ids, np.int64)
    if ids.size and (ids.min() < 0 or ids.max() >= num_keys):
        raise ValueError("a segment id is out of range")
    counts = np.bincount(ids, minlength=num_keys)
    srt = bool(np.all(ids[1:] >= ids[:-1]))
    starts, firsts = _chunk_levels(counts)

    def dev(a):
        return _dev_i32(a, device)

    if not srt:
        return SegmentPlan(dev(ids), num_keys, dev(np.argsort(ids, kind="stable")),
                           tuple(dev(a) for a in starts), dev(firsts[-1]), None)
    (tile_run, run_start, run_dest, n_partials, empty_keys, run_starts, fin_first,
     fin_keys) = _segment_runs(ids, num_keys)
    return SegmentPlan(
        dev(ids), num_keys, None, tuple(dev(a) for a in starts), dev(firsts[-1]),
        dev(np.concatenate([[0], np.cumsum(counts)])), dev(tile_run), dev(run_start),
        dev(run_dest), n_partials, dev(empty_keys), tuple(dev(a) for a in run_starts),
        dev(fin_first), dev(fin_keys))


class SlotPlanFlat(NamedTuple):
    """One (kind, slot) entry of a flat-ops plan (flatops.py:271)."""

    s: int  # slot index within the kind
    fi: int  # family index within the partition's fams list
    off: int  # family tangent offset (partition-local)
    nv: int  # variable blocks in the family
    t: int  # tangent width
    local: torch.Tensor  # (B,) int32 local block ids (sentinel == nv)
    srt: bool  # ids nondecreasing over the rows
    seg: SegmentPlan  # the reduction plan over nv + 1 keys


class _FlatOpsBase:
    """Plan building and the products over flattened Jacobian blocks
    (flatops.py:305). Plan entries are SlotPlanFlat against a `fams`
    layout list [(off, nv, t, bid_off)]. The JAX class's contiguity check
    (`supported`) holds by construction here: every family is one
    parameter block array, so a block's tangent indices are contiguous."""

    def __init__(self, kinds, device):
        self.kinds = kinds  # bsr.KindMeta: row_offset, B, r per kind
        self.device = device

    def _build(self, slot_info):
        """slot_info: (k, s, fi, off, nv, t, block ids (B,) local to the
        family, sentinel >= nv) for every participating slot. A slot of a
        family with no variable block (a constant array) gets no plan: no
        product or reduction reads or writes it."""
        plans: List[List[SlotPlanFlat]] = [[] for _ in self.kinds]
        for (k, s, fi, off, nv, t, bid) in slot_info:
            if nv == 0:
                continue
            local = np.minimum(np.maximum(np.asarray(bid, np.int64), 0), nv)
            seg = build_segment_plan(local, nv + 1, self.device)
            plans[k].append(SlotPlanFlat(s, fi, off, nv, t, seg.ids,
                                         seg.order is None, seg))
        return plans

    @staticmethod
    def _reduce_rows(table, pe: SlotPlanFlat, contrib):
        """table + the segment sum of contrib (B, w) by pe's block ids:
        kernel 6 for sorted ids, kernel 9 otherwise (flatops.py:359). A
        table of None is a family's first slot: the sum itself is the table
        (0 + x = x), so no zero table is filled, read and written again."""
        reduce = kn.segment_block_sum if pe.srt else kn.unsorted_segment_sum
        out = reduce(contrib.contiguous(), pe.seg)
        return out if table is None else table + out

    @staticmethod
    def _expand(rows, pe: SlotPlanFlat):
        """(B, w): row b is rows[local[b]] of a per-block table (nv, w),
        zero for the sentinel (kernel 7)."""
        table = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
        return kn.segment_block_expand(table, pe.local)

    def _gather(self, v, pe: SlotPlanFlat):
        """(B, t): each row's block of a partition-layout vector
        (flatops.py:458)."""
        return self._expand(v[pe.off:pe.off + pe.nv * pe.t].reshape(pe.nv, pe.t), pe)

    def _jac(self, vflat, k, pe: SlotPlanFlat):
        kind = self.kinds[k]
        return vflat[k][pe.s].reshape(kind.B, kind.r, pe.t)

    def _rows(self, u, k):
        kind = self.kinds[k]
        return u[kind.row_offset:kind.row_offset + kind.B * kind.r].reshape(
            kind.B, kind.r)

    def _right(self, plans, vflat, v):
        """J x over the plans' columns, for x in partition layout."""
        outs = []
        for k, kind in enumerate(self.kinds):
            acc = v.new_zeros((kind.B, kind.r))
            for pe in plans[k]:
                acc = acc + torch.sum(self._jac(vflat, k, pe)
                                      * self._gather(v, pe)[:, None, :], dim=2)
            outs.append(acc.reshape(-1))
        return torch.cat(outs)

    def _left(self, plans, fams, vflat, u):
        """J'u over the plans' columns, in partition layout."""
        tables = [None] * len(fams)
        for k in range(len(self.kinds)):
            if not plans[k]:
                continue
            rows = self._rows(u, k)
            for pe in plans[k]:
                contrib = torch.sum(self._jac(vflat, k, pe) * rows[:, :, None], dim=1)
                tables[pe.fi] = self._reduce_rows(tables[pe.fi], pe, contrib)
        tables = _zero_if_none(tables, [(nv + 1, t) for (_, nv, t, _) in fams], u)
        return _concat([tab[:nv].reshape(-1) for tab, (_, nv, _, _) in zip(tables, fams)],
                       u)

    def fused_post_eval(self, plans, fams, vflat, u, with_blocks=True):
        """ONE segment reduction per (kind, slot) of the concatenated
        gradient J'u, squared column norms diag(J'J) and, with
        `with_blocks`, J'J diagonal blocks (flatops.py:539). Returns (g,
        sqn, [blocks (nv, t*t)] or None) in this partition's layout."""
        tables = [None] * len(fams)
        for k in range(len(self.kinds)):
            if not plans[k]:
                continue
            rows = self._rows(u, k)
            for pe in plans[k]:
                contrib = self.post_contrib(self._jac(vflat, k, pe), rows, with_blocks)
                tables[pe.fi] = self._reduce_rows(tables[pe.fi], pe, contrib)
        w = (lambda t: 2 * t + t * t) if with_blocks else (lambda t: 2 * t)
        tables = _zero_if_none(tables, [(nv + 1, w(t)) for (_, nv, t, _) in fams], u)
        g = _concat([tab[:nv, :t].reshape(-1)
                     for tab, (_, nv, t, _) in zip(tables, fams)], u)
        sqn = _concat([tab[:nv, t:2 * t].reshape(-1)
                       for tab, (_, nv, t, _) in zip(tables, fams)], u)
        if not with_blocks:
            return g, sqn, None
        return g, sqn, [tab[:nv, 2 * t:] for tab, (_, nv, t, _) in zip(tables, fams)]

    @staticmethod
    def post_contrib(J, rows, with_blocks=True):
        """(B, 2t + t*t) per row: J'u, diag(J'J) and the J'J block, for
        J (B, r, t) and residual rows (B, r); (B, 2t) without the block."""
        parts = [torch.sum(J * rows[:, :, None], dim=1), torch.sum(J * J, dim=1)]
        if with_blocks:
            parts.append(small_matmul(J.transpose(1, 2), J).reshape(J.shape[0], -1))
        return torch.cat(parts, dim=1)

    @staticmethod
    def flatten(values):
        """(B, r*t) views of the block values [kind][slot] (B, r, t)
        (flatops.py:449)."""
        return tuple(tuple(V.reshape(V.shape[0], -1) for V in jacs) for jacs in values)

    def _scale_plans(self, plans, vflat, scale, out):
        """Into out[k][s]: the blocks of each plan's slot times its rows'
        column scales (bsr.scale_columns), scale in the plans' layout."""
        for k, kind in enumerate(self.kinds):
            for pe in plans[k]:
                out[k][pe.s] = (self._jac(vflat, k, pe)
                                * self._gather(scale, pe)[:, None, :]).reshape(kind.B, -1)

    def block_jtj(self, plans, fams, vflat):
        """Per family (nv, t*t): the diagonal blocks of J'J over the plans'
        columns, one reduction per (kind, slot) (flatops.py:597)."""
        tables = [None] * len(fams)
        for k in range(len(self.kinds)):
            for pe in plans[k]:
                J = self._jac(vflat, k, pe)
                tables[pe.fi] = self._reduce_rows(
                    tables[pe.fi], pe, small_matmul(J.transpose(1, 2), J).reshape(J.shape[0], -1))
        tables = _zero_if_none(tables, [(nv + 1, t * t) for (_, nv, t, _) in fams],
                               vflat[0][0])
        return [tab[:nv] for tab, (_, nv, _, _) in zip(tables, fams)]

    @staticmethod
    def inverse_flats(fams, blocks, D):
        """Per family (nv, t*t): the inverses of blocks + diag(D)^2, D in
        the families' layout (the Cholesky solves of flatops.py:657)."""
        return [spd_inverse_flat(blk + torch.diag_embed(
            (D[off:off + nv * t] ** 2).reshape(nv, t)).reshape(nv, t * t), t)
            for (off, nv, t, _), blk in zip(fams, blocks)]

    @staticmethod
    def scaled_blocks(fams, blocks, scale, D2):
        """S_b (J'J)_b S_b + diag(D2)_b per family."""
        return [scaled_blocks(blk, scale[off:off + nv * t], D2[off:off + nv * t], t)
                for (off, nv, t, _), blk in zip(fams, blocks)]

    @staticmethod
    def scaled_block_inverses(fams, blocks, scale, D2):
        """Their inverses (flatops.py:633)."""
        return [spd_inverse_flat(M, t) for M, (_, _, t, _) in zip(
            _FlatOpsBase.scaled_blocks(fams, blocks, scale, D2), fams)]

    @staticmethod
    def apply_inverse_rows(fams, invs, v):
        """x = blockdiag^{-1} v per family (flatops.py:648)."""
        return _concat([apply_inverse_rows(M, v[off:off + nv * t], t)
                        for (off, nv, t, _), M in zip(fams, invs)], v)


def _zero_if_none(tables, shapes, like):
    """Each family's table, zeros of its shape where no slot reduced into
    it (_reduce_rows)."""
    return [like.new_zeros(shape) if tab is None else tab
            for tab, shape in zip(tables, shapes)]


def _concat(parts, like):
    return torch.cat(parts) if parts else like.new_zeros((0,))


class FlatSchurOps(_FlatOpsBase):
    """Flattened products over the e/f partition (flatops.py:744): the
    path of every program that `jt_refusal` turns away."""

    def __init__(self, pm: pt.PartitionedMeta, program):
        # `program`: a CompiledProgram, or the torch.device of its tensors
        super().__init__(pm.base.kinds, getattr(program, "device", program))
        self.pm = pm
        self.plans_e = self._build(self._slots(pm.e_family_indices, pm.e_fams))
        self.plans_f = self._build(self._slots(pm.f_family_indices, pm.f_fams))

    def _slots(self, part_list, fams):
        part_list = list(part_list)
        for k, kind in enumerate(self.pm.base.kinds):
            for s, slot in enumerate(kind.slots):
                if slot.family_index not in part_list:
                    continue
                fi = part_list.index(slot.family_index)
                off, nv, t, _ = fams[fi]
                bid_off = self.pm.base.families[slot.family_index].block_id_offset
                yield k, s, fi, off, nv, t, slot.block_ids - bid_off

    def right_f(self, vflat, z):
        return self._right(self.plans_f, vflat, z)

    def right_e(self, vflat, y):
        return self._right(self.plans_e, vflat, y)

    def left_f(self, vflat, u):
        return self._left(self.plans_f, self.pm.f_fams, vflat, u)

    def left_e(self, vflat, u):
        return self._left(self.plans_e, self.pm.e_fams, vflat, u)

    def fused_post_eval_e(self, vflat, u):
        return self.fused_post_eval(self.plans_e, self.pm.e_fams, vflat, u)

    def fused_post_eval_f(self, vflat, u):
        return self.fused_post_eval(self.plans_f, self.pm.f_fams, vflat, u)

    # -- the host loop's operations (bsr_kernels.py:62, implicit_schur.py)

    def right(self, vflat, v):
        """J v for v in the global tangent layout."""
        pm = self.pm
        return self.right_e(vflat, pt.extract_e(pm, v)) + self.right_f(vflat, pt.extract_f(pm, v))

    def left(self, vflat, u):
        """J'u in the global tangent layout."""
        return pt.combine(self.pm, self.left_e(vflat, u), self.left_f(vflat, u))

    def gradient_and_norms(self, vflat, u):
        """(J'u, diag(J'J)) in the global tangent layout, one reduction per
        (kind, slot)."""
        pm = self.pm
        g_e, sqn_e, _ = self.fused_post_eval(self.plans_e, pm.e_fams, vflat, u, False)
        g_f, sqn_f, _ = self.fused_post_eval(self.plans_f, pm.f_fams, vflat, u, False)
        return pt.combine(pm, g_e, g_f), pt.combine(pm, sqn_e, sqn_f)

    def scale_columns(self, vflat, scale):
        """vflat of J diag(scale), scale in the global tangent layout."""
        out = [list(jacs) for jacs in vflat]
        self._scale_plans(self.plans_e, vflat, pt.extract_e(self.pm, scale), out)
        self._scale_plans(self.plans_f, vflat, pt.extract_f(self.pm, scale), out)
        return tuple(tuple(jacs) for jacs in out)

    def block_ete(self, vflat):
        """Per e family (nv, t*t): the diagonal blocks of E'E."""
        return self.block_jtj(self.plans_e, self.pm.e_fams, vflat)

    def block_ftf(self, vflat):
        """Per f family (nv, t*t): the diagonal blocks of F'F."""
        return self.block_jtj(self.plans_f, self.pm.f_fams, vflat)

    def minv_apply(self, minv, v):
        """(E'E + D_e^2)^{-1} v from its inverse blocks (flatops.py:803)."""
        return self.apply_inverse_rows(self.pm.e_fams, minv, v)

    def schur_multiply(self, vflat, minv, D_f, z):
        """S z = F'F z + D_f^2 z - F'E (E'E + D_e^2)^{-1} E'F z through four
        products (flatops.py:806)."""
        fz = self.right_f(vflat, z)
        etfz = self.left_e(vflat, fz)
        e_part = self.right_e(vflat, self.minv_apply(minv, etfz))
        return self.left_f(vflat, fz - e_part) + (D_f * D_f) * z

    def schur_jacobi_blocks(self, vflat, minv, D_f):
        """Per f family (nv, t*t): the diagonal blocks of S, F'F + D_f^2
        less each row's W' M^{-1} W, W = E_b'F_b (implicit_schur.py:70;
        exact when an (e, f) block pair shares at most one row)."""
        pm = self.pm
        tables = []
        for (off, nv, t, _), blk in zip(pm.f_fams, self.block_ftf(vflat)):
            d2 = (D_f[off:off + nv * t] ** 2).reshape(nv, t)
            tables.append(torch.cat([blk + torch.diag_embed(d2).reshape(nv, t * t),
                                     blk.new_zeros((1, t * t))]))
        for k, kind in enumerate(self.kinds):
            if not self.plans_e[k] or not self.plans_f[k]:
                continue
            pe = self.plans_e[k][0]
            Je = self._jac(vflat, k, pe)
            minv_rows = self._expand(minv[pe.fi], pe).reshape(kind.B, pe.t, pe.t)
            for pf in self.plans_f[k]:
                W = small_matmul(Je.transpose(1, 2), self._jac(vflat, k, pf))
                corr = small_matmul(W.transpose(1, 2), small_matmul(minv_rows, W))
                tables[pf.fi] = self._reduce_rows(tables[pf.fi], pf, -corr.reshape(kind.B, -1))
        return [tab[:nv] for tab, (_, nv, _, _) in zip(tables, pm.f_fams)]


class FlatJacobianOps(_FlatOpsBase):
    """Flattened J and J' products over the whole tangent (flatops.py:1271):
    the CGNR path, bsr.right_multiply and bsr.left_multiply over the
    per-(kind, slot) plans, in the global tangent layout.

    On a BAL-shaped program (one kind of r = 2 rows, two slots: a camera
    family of t = 9 and a point family of t = 3 whose ids are sorted, as
    the program sorts its rows) the CGNR product (J_s'J_s) x is one launch
    of normal_matvec (kernel 4) over the transposed lanes JT (24, B) and a
    row plan built once (`make_kernel_matvec`); any other program takes
    the product chain right/left. Unlike the JAX qualification
    (flatops.py:1339), both dtypes take the kernel."""

    def __init__(self, meta, program):
        # `program`: a CompiledProgram, or the torch.device of its tensors
        device = getattr(program, "device", program)
        super().__init__(meta.kinds, device)
        self.meta = meta
        self.fams = tuple((f.tangent_offset, f.num_var, f.t, f.block_id_offset)
                          for f in meta.families)
        self.plans = self._build(self._slots())
        self.kernel_slots = self._kernel_slots()
        self.plan = None
        if self.kernel_slots is not None:
            pe, pf = self.kernel_slots
            # a constant camera's rows hold the sentinel id nv; no
            # eval_fused reads a camera table through this plan
            self.plan = build_row_plan(pe.local.cpu().numpy(), pf.local.cpu().numpy(),
                                       pe.nv, pf.nv, device, n_cams=pf.nv + 1)

    def _slots(self):
        for k, kind in enumerate(self.meta.kinds):
            for s, slot in enumerate(kind.slots):
                fi = slot.family_index
                off, nv, t, bid_off = self.fams[fi]
                yield k, s, fi, off, nv, t, slot.block_ids - bid_off

    def _kernel_slots(self):
        """(point plan, camera plan) of a program normal_matvec takes, or
        None (flatops.py:1333-1339, without its float32 condition)."""
        if len(self.kinds) != 1 or len(self.plans[0]) != 2 or self.kinds[0].r != kn.R:
            return None
        a, b = self.plans[0]
        pe, pf = (a, b) if a.t == kn.TE else (b, a)
        if (pe.t, pf.t) != (kn.TE, kn.TF) or not pe.srt:
            return None
        if int(pe.seg.seg_start[-1]) != int(pe.seg.seg_start[pe.nv]):
            return None  # a constant point: the row plan's points are all variable
        return pe, pf

    def right(self, vflat, x):
        """J x."""
        return self._right(self.plans, vflat, x)

    def left(self, vflat, u):
        """J'u."""
        return self._left(self.plans, self.fams, vflat, u)

    def fused_post_eval_all(self, vflat, u):
        """(gradient, diag(J'J), per-family J'J blocks) in one reduction
        pass per slot."""
        return self.fused_post_eval(self.plans, self.fams, vflat, u)

    def gradient_and_norms(self, vflat, u):
        """(J'u, diag(J'J)), one reduction per (kind, slot)."""
        g, sqn, _ = self.fused_post_eval(self.plans, self.fams, vflat, u, False)
        return g, sqn

    def scale_columns(self, vflat, scale):
        """vflat of J diag(scale)."""
        out = [list(jacs) for jacs in vflat]
        self._scale_plans(self.plans, vflat, scale, out)
        return tuple(tuple(jacs) for jacs in out)

    def block_jtj_all(self, vflat):
        """Per family (nv, t*t): the diagonal blocks of J'J."""
        return self.block_jtj(self.plans, self.fams, vflat)

    def normal_multiply(self, vflat, D, x):
        """(J'J + D^2) x through the product chain (flatops.py:1324)."""
        return self.left(vflat, self.right(vflat, x)) + (D * D) * x

    def kernel_lanes(self, vflat):
        """JT (24, B), the unscaled Jacobian lanes normal_matvec reads
        (layout in csrc/common.cuh), or None for a program it does not
        take. Built once per evaluation."""
        if self.kernel_slots is None:
            return None
        pe, pf = self.kernel_slots
        return torch.cat([vflat[0][pf.s].T, vflat[0][pe.s].T]).contiguous()

    def make_kernel_matvec(self, JT, scale):
        """(J_s'J_s) x in the tangent layout through normal_matvec, the
        Jacobi scales folded into its small operands as
        JTSchurOps.make_kernel_suite_raw's `normal` does; None without JT."""
        if JT is None:
            return None
        pe, pf = self.kernel_slots
        P, C = pe.nv, pf.nv
        se = scale[pe.off:pe.off + P * kn.TE].reshape(P, kn.TE)
        sf = scale[pf.off:pf.off + C * kn.TF].reshape(C, kn.TF)
        plan = self.plan
        e_first = pe.off < pf.off

        def matvec(x):
            xc = x[pf.off:pf.off + C * kn.TF].reshape(C, kn.TF)
            xp = x[pe.off:pe.off + P * kn.TE].reshape(P, kn.TE)
            cam, ptv = kn.normal_matvec(JT, (sf * xc).contiguous(),
                                        (se * xp).contiguous(), plan)
            cam, ptv = (sf * cam).reshape(-1), (se * ptv).reshape(-1)
            return torch.cat([ptv, cam] if e_first else [cam, ptv])

        return matvec
