"""The row plan's fields for the point and camera passes of isc_matvec,
normal_matvec and post_eval_fused (ops/flatops.build_row_plan): each row's
place in camera order, the point blocks, the runs of one camera within a
tile of rows and the camera sum's trees of levels, on structures with a
long track, points without rows and a camera of thousands of rows; and the
host arrays of a SegmentPlan's levels."""
import dataclasses

import numpy as np
import pytest

from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.ops import flatops as fo
from ceres_tpu_torch.ops import kernels as kn


def _structure(name):
    """(pt, cam, P, C): rows sorted by point."""
    rng = np.random.default_rng(5)
    if name == "venice_like":
        b = tbal.synthetic_bal_large(num_cameras=60, num_points=3000, cam_window=12,
                                     seed=2)
        order = np.argsort(b.point_index, kind="stable")
        return (b.point_index[order], b.camera_index[order], b.num_points,
                b.num_cameras)
    P, C = 1500, 7
    counts = rng.integers(1, 6, P)
    counts[17], counts[3], counts[1400] = 600, 0, 0
    if name == "long_tracks":
        counts[900:903] = [256, 257, 1000]
    pt = np.repeat(np.arange(P), counts)
    cam = np.where(rng.uniform(size=pt.shape[0]) < 0.85, 0,
                   rng.integers(1, C, pt.shape[0]))
    return pt, cam, P, C


_NAMES = ["long_track", "long_tracks", "venice_like"]


@pytest.mark.parametrize("name", _NAMES)
def test_cam_pos_is_the_inverse_of_cam_rows(name):
    pt, cam, P, C = _structure(name)
    plan = fo.build_row_plan(pt, cam, P, C, "cpu", n_cams=C)
    rows, pos = plan.cam_rows.numpy(), plan.cam_pos.numpy()
    B = pt.shape[0]
    assert np.array_equal(pos[rows], np.arange(B))
    assert np.array_equal(rows[pos], np.arange(B))
    # a row's place lies in its camera's run of the camera order
    cam_start = np.concatenate([[0], np.cumsum(np.bincount(cam, minlength=C))])
    assert np.all(pos >= cam_start[cam]) and np.all(pos < cam_start[cam + 1])


@pytest.mark.parametrize("name", _NAMES)
def test_point_blocks_cover_every_row_once_and_split_no_point(name):
    """Blocks run over consecutive whole points from the first to the last,
    so every row lies in exactly one block and no point is split; a block
    holds at most kn.POINT_BLOCK rows and points, or one point of more rows
    (the block that loops). Greedy: the next point would not have fit."""
    pt, cam, P, C = _structure(name)
    plan = fo.build_row_plan(pt, cam, P, C, "cpu", n_cams=C)
    blk, start = plan.pt_block.numpy().astype(np.int64), plan.pt_start.numpy()
    cap = kn.POINT_BLOCK
    assert blk[0] == 0 and blk[-1] == P and np.all(np.diff(blk) >= 1)
    assert plan.n_pt_blocks == blk.shape[0] - 1
    rows = start[blk[1:]] - start[blk[:-1]]
    assert rows.sum() == pt.shape[0]
    npts = np.diff(blk)
    looping = rows > cap
    assert np.all(npts[looping] == 1)
    assert np.all(npts[~looping] <= cap)
    nxt = np.minimum(blk[1:-1] + 1, P)
    grown = start[nxt] - start[blk[:-2]]
    assert np.all((grown > cap) | (npts[:-1] + 1 > cap))
    if name != "venice_like":
        assert looping.sum() == (3 if name == "long_tracks" else 1)


@pytest.mark.parametrize("name", _NAMES)
def test_camera_levels_sum_each_camera_in_a_fixed_tree(name):
    """Level 0 is the camera chunk plan; every chunk of every level holds
    at most kn.CHUNK items of one camera; summing values through the levels
    and the last level's per-camera chunks gives each camera's sum."""
    pt, cam, P, C = _structure(name)
    plan = fo.build_row_plan(pt, cam, P, C, "cpu", n_cams=C)
    assert plan.cam_levels[0] is plan.cam_chunk_start
    assert plan.cam_level_sizes[0] == plan.cam_chunk_start.shape[0] - 1
    if name != "venice_like":
        assert len(plan.cam_levels) == 2
    vals = np.random.default_rng(0).standard_normal(pt.shape[0])
    x = vals[plan.cam_rows.numpy()]  # in camera order
    for cs in plan.cam_levels:
        cs = cs.numpy().astype(np.int64)
        assert cs[0] == 0 and cs[-1] == x.shape[0]
        assert np.all(np.diff(cs) <= kn.CHUNK)
        x = np.array([x[a:b].sum() for a, b in zip(cs[:-1], cs[1:])])
    first = plan.cam_level_first.numpy().astype(np.int64)
    assert first.shape == (C + 1,) and np.all(np.diff(first) <= kn.CHUNK)
    out = np.array([x[a:b].sum() for a, b in zip(first[:-1], first[1:])])
    np.testing.assert_allclose(out, np.bincount(cam, vals, minlength=C), rtol=1e-12,
                               atol=1e-9)


@pytest.mark.parametrize("name", _NAMES)
def test_camera_levels_host_arrays_are_built_once_and_follow_the_levels(name):
    """isc_matvec passes the camera levels as host arrays of their chunk
    counts and device pointers, which the plan builds once; a plan made
    anew by dataclasses.replace builds them from its own levels, and a
    level that is not int32 is refused there."""
    import dataclasses

    import torch

    pt, cam, P, C = _structure(name)
    plan = fo.build_row_plan(pt, cam, P, C, "cpu", n_cams=C)
    levels = plan.cam_levels
    assert plan.cam_level_sizes == tuple(int(s.shape[0]) - 1 for s in levels)
    assert list(plan.cam_level_counts) == list(plan.cam_level_sizes)
    assert list(plan.cam_level_ptrs) == [s.data_ptr() for s in levels]
    cut = dataclasses.replace(plan, cam_levels=levels[:1])
    assert list(cut.cam_level_counts) == [plan.cam_level_sizes[0]]
    assert list(cut.cam_level_ptrs) == [levels[0].data_ptr()]
    with pytest.raises(TypeError, match="cam_levels"):
        dataclasses.replace(plan, cam_levels=(levels[0].to(torch.int64),))


def _tiles(plan):
    """Each tile's first row and end, from the point blocks: a block's rows,
    or kn.POINT_BLOCK of them in a block of one longer point."""
    start, blk = plan.pt_start.numpy().astype(np.int64), plan.pt_block.numpy()
    first = plan.tile_first.numpy().astype(np.int64)
    t0, t1 = [], []
    for k in range(plan.n_pt_blocks):
        a, e = start[blk[k]], start[blk[k + 1]]
        n = first[k + 1] - first[k]
        assert n == max(1, -(-(e - a) // kn.POINT_BLOCK))
        for j in range(n):
            t0.append(a + j * kn.POINT_BLOCK)
            t1.append(min(a + (j + 1) * kn.POINT_BLOCK, e))
    return np.asarray(t0), np.asarray(t1)


@pytest.mark.parametrize("name", _NAMES)
def test_camera_runs_cover_every_row_once_by_tile_and_camera(name):
    """post_eval_fused's runs: every row in exactly one run; a run's rows
    share a camera and a tile and come in row order; a tile's runs are its
    cameras in order; run_pos puts the runs in camera order (tile order
    within a camera); summing values through the run levels and the last
    level's per-camera chunks gives each camera's sum."""
    pt, cam, P, C = _structure(name)
    plan = fo.build_row_plan(pt, cam, P, C, "cpu", n_cams=C)
    B = pt.shape[0]
    t0, t1 = _tiles(plan)
    assert plan.n_tiles == t0.shape[0] and t1[-1] == B
    tile_of_row = np.repeat(np.arange(t0.shape[0]), t1 - t0)
    slot = plan.run_slot.numpy().astype(np.int64)
    rs = plan.run_start.numpy().astype(np.int64)
    assert np.array_equal(np.sort(slot), np.arange(B))
    rows = np.empty(B, np.int64)
    rows[slot] = np.arange(B)  # the rows in run order
    # a row's place lies in its own tile's range of places
    assert np.all((slot >= t0[tile_of_row]) & (slot < t1[tile_of_row]))
    assert rs[0] == 0 and rs[-1] == B and np.all(np.diff(rs) >= 1)
    run_of = np.repeat(np.arange(plan.n_runs), np.diff(rs))
    run_cam = cam[rows[rs[:-1]]]
    run_tile = tile_of_row[rows[rs[:-1]]]
    assert np.array_equal(cam[rows], run_cam[run_of])
    assert np.array_equal(tile_of_row[rows], run_tile[run_of])
    same = run_of[1:] == run_of[:-1]
    assert np.all(rows[1:][same] > rows[:-1][same])
    tr = plan.tile_run.numpy().astype(np.int64)
    assert np.array_equal(tr, np.concatenate(
        [[0], np.cumsum(np.bincount(run_tile, minlength=plan.n_tiles))]))
    in_tile = run_tile[1:] == run_tile[:-1]
    assert np.all(run_cam[1:][in_tile] > run_cam[:-1][in_tile])
    pos = plan.run_pos.numpy().astype(np.int64)
    by_cam = np.empty_like(pos)
    by_cam[pos] = np.arange(plan.n_runs)
    key = run_cam[by_cam] * plan.n_tiles + run_tile[by_cam]
    assert np.all(np.diff(key) > 0)
    vals = np.random.default_rng(1).standard_normal(B)
    x = np.add.reduceat(vals[rows], rs[:-1])[by_cam] if B else vals
    for cs in plan.run_levels:
        cs = cs.numpy().astype(np.int64)
        assert cs[0] == 0 and cs[-1] == x.shape[0] and np.all(np.diff(cs) <= kn.CHUNK)
        x = np.array([x[a:b].sum() for a, b in zip(cs[:-1], cs[1:])])
    first = plan.run_level_first.numpy().astype(np.int64)
    assert first.shape == (C + 1,) and np.all(np.diff(first) <= kn.CHUNK)
    out = np.array([x[a:b].sum() for a, b in zip(first[:-1], first[1:])])
    np.testing.assert_allclose(out, np.bincount(cam, vals, minlength=C), rtol=1e-12,
                               atol=1e-9)
    assert plan.n_runs < B / 2  # runs gather rows: a tile's rows see few cameras


@pytest.mark.parametrize("name", _NAMES)
def test_run_levels_host_arrays_are_built_once_and_follow_the_levels(name):
    """post_eval_fused passes the run levels as host arrays, which the plan
    builds once, as it does the camera levels'."""
    import torch

    pt, cam, P, C = _structure(name)
    plan = fo.build_row_plan(pt, cam, P, C, "cpu", n_cams=C)
    levels = plan.run_levels
    assert plan.run_level_sizes == tuple(int(s.shape[0]) - 1 for s in levels)
    assert list(plan.run_level_counts) == list(plan.run_level_sizes)
    assert list(plan.run_level_ptrs) == [s.data_ptr() for s in levels]
    with pytest.raises(TypeError, match="run_levels"):
        dataclasses.replace(plan, run_levels=(levels[0].to(torch.int64),))


@pytest.mark.parametrize("ids", ["sorted", "unsorted", "one_key"])
def test_segment_plan_host_arrays_are_built_once_and_follow_the_levels(ids):
    """segment_block_sum and unsorted_segment_sum pass a SegmentPlan's levels
    as host arrays of their chunk counts and device pointers, which the plan
    builds once (the wrappers build none per call); a plan made anew by
    dataclasses.replace builds them from its own levels, and a level that is
    not int32 is refused there. "one_key" holds 5,000 rows under one key:
    two levels."""
    import torch

    rng = np.random.default_rng(3)
    keys = {"sorted": np.sort(rng.integers(0, 50, 3000)),
            "unsorted": rng.integers(0, 50, 3000),
            "one_key": np.zeros(5000, np.int64)}[ids]
    plan = fo.build_segment_plan(keys, 50, "cpu")
    levels = plan.level_starts
    assert len(levels) == (2 if ids == "one_key" else 1)
    assert plan.level_sizes == tuple(int(s.shape[0]) - 1 for s in levels)
    assert list(plan.level_counts) == list(plan.level_sizes)
    assert list(plan.level_ptrs) == [s.data_ptr() for s in levels]
    cut = dataclasses.replace(plan, level_starts=levels[:1])
    assert list(cut.level_counts) == [plan.level_sizes[0]]
    assert list(cut.level_ptrs) == [levels[0].data_ptr()]
    with pytest.raises(TypeError, match="level_starts"):
        dataclasses.replace(plan, level_starts=(levels[0].to(torch.int64),))


@pytest.mark.parametrize("ids", ["sorted", "one_key"])
def test_segment_runs_cover_every_row_once_by_tile_and_key(ids):
    """segment_block_sum's runs: every row in exactly one run; a run's rows
    share a key and come in row order, from the run's tile of kn.SEG_TILE
    rows; a key is one run exactly where it has rows and they end at most
    kn.SEG_HALO rows past the tile of its first row (so past it only then),
    else a run in each tile it meets; a tile's runs are its keys in order; a
    key of one run is flagged to write out directly (run_dest >=
    n_partials, its key), the others' runs write their partials in key
    order (tile order within a key); the keys of no row are empty_keys;
    summing through the run levels and fin_first gives each fin key's sum,
    and the fin keys are exactly the keys of several runs. "one_key" holds
    70 tiles under one key: two chunks of partials, which the last pass
    sums; "sorted" keys of up to 60 rows, and of 300 and 700, have seven
    partials at most, which the last pass sums without a run level."""
    rng = np.random.default_rng(5)
    counts = {"sorted": rng.integers(0, 61, 50),
              "one_key": np.array([70 * kn.SEG_TILE - 3] + [0] * 49)}[ids]
    if ids == "sorted":
        counts[[10, 30]] = 300, 700
        counts[[4, 5]] = 0
    keys = np.repeat(np.arange(50), counts)
    n = keys.shape[0]
    plan = fo.build_segment_plan(keys, 50, "cpu")
    tile_of_row = np.arange(n) // kn.SEG_TILE
    n_tiles = tile_of_row[-1] + 1
    rs = plan.run_start.numpy().astype(np.int64)
    rows = np.arange(n)  # the rows in run order: sorted ids keep theirs
    assert rs[0] == 0 and rs[-1] == n and np.all(np.diff(rs) >= 1)
    run_of = np.repeat(np.arange(plan.n_runs), np.diff(rs))
    run_key = keys[rows[rs[:-1]]]
    run_tile = tile_of_row[rows[rs[:-1]]]
    assert np.array_equal(keys[rows], run_key[run_of])
    same = run_of[1:] == run_of[:-1]
    assert np.all(rows[1:][same] > rows[:-1][same])
    runs_per_key = np.bincount(run_key, minlength=50)
    first = np.concatenate([[0], np.cumsum(counts)])
    whole = first[1:] <= (first[:-1] // kn.SEG_TILE + 1) * kn.SEG_TILE + kn.SEG_HALO
    assert np.array_equal(runs_per_key == 1, whole & (counts > 0))
    assert np.array_equal(runs_per_key == 0, counts == 0)
    assert np.array_equal(plan.empty_keys.numpy(), np.flatnonzero(counts == 0))
    past = rs[1:] - (run_tile + 1) * kn.SEG_TILE  # rows past the run's tile
    alone = runs_per_key[run_key] == 1
    assert np.all(past <= np.where(alone, kn.SEG_HALO, 0))
    assert ids == "one_key" or (past > 0).any()
    assert np.array_equal(plan.tile_run.numpy(), np.concatenate(
        [[0], np.cumsum(np.bincount(run_tile, minlength=n_tiles))]))
    in_tile = run_tile[1:] == run_tile[:-1]
    assert np.all(run_key[1:][in_tile] > run_key[:-1][in_tile])
    dest = plan.run_dest.numpy().astype(np.int64)
    direct = dest >= plan.n_partials
    assert np.array_equal(direct, runs_per_key[run_key] == 1)
    assert np.array_equal(dest[direct] - plan.n_partials, run_key[direct])
    assert np.array_equal(np.sort(dest[~direct]), np.arange(plan.n_partials))
    by_partial = np.empty(plan.n_partials, np.int64)
    by_partial[dest[~direct]] = np.flatnonzero(~direct)
    key = run_key[by_partial] * n_tiles + run_tile[by_partial]
    assert np.all(np.diff(key) > 0)
    fin = plan.fin_keys.numpy()
    assert np.array_equal(fin, np.flatnonzero(runs_per_key > 1))
    vals = np.random.default_rng(1).standard_normal(n)
    x = np.add.reduceat(vals[rows], rs[:-1])[by_partial]
    # no run levels where every key has at most CHUNK partials: the last
    # pass sums them
    assert len(plan.run_levels) == (1 if ids == "one_key" else 0)
    for cs in plan.run_levels:
        cs = cs.numpy().astype(np.int64)
        assert cs[0] == 0 and cs[-1] == x.shape[0] and np.all(np.diff(cs) <= kn.CHUNK)
        x = np.array([x[a:b].sum() for a, b in zip(cs[:-1], cs[1:])])
    first = plan.fin_first.numpy().astype(np.int64)
    assert first.shape == (fin.shape[0] + 1,) and np.all(np.diff(first) <= kn.CHUNK)
    assert ids != "one_key" or first[1] - first[0] == 2
    out = np.array([x[a:b].sum() for a, b in zip(first[:-1], first[1:])])
    np.testing.assert_allclose(out, np.bincount(keys, vals, minlength=50)[fin],
                               rtol=1e-12, atol=1e-9)
    assert list(plan.run_level_counts) == list(plan.run_level_sizes)
    assert list(plan.run_level_ptrs) == [s.data_ptr() for s in plan.run_levels]


@pytest.mark.parametrize("name", _NAMES)
def test_pair_plan_holds_each_unordered_pair_once_by_key(name):
    """The dense Schur assembly's pairs: each pair of two rows of one point
    once, a from the lower camera (the earlier row within one camera), in
    camera-pair key order (the upper triangle of C x C, row by row), by
    point within a key; level 0 cuts each key's pairs into
    chunks of at most kn.CHUNK, and summing values through the levels and
    the last level's per-key chunks gives each key's sum."""
    pt, cam, P, C = _structure(name)
    plan = fo.build_row_plan(pt, cam, P, C, "cpu", n_cams=C)
    assert plan.pairs is None
    pairs = plan.ensure_pairs()
    assert plan.ensure_pairs() is pairs
    a = pairs.pair_a.numpy().astype(np.int64)
    b = pairs.pair_b.numpy().astype(np.int64)
    m = np.bincount(pt, minlength=P)
    assert a.shape[0] == int(np.sum(m * (m - 1) // 2))
    assert np.all(pt[a] == pt[b])
    assert np.all((cam[a] < cam[b]) | ((cam[a] == cam[b]) & (a < b)))
    assert np.unique(a * pt.shape[0] + b).shape[0] == a.shape[0]
    rows, cols = np.triu_indices(C)
    assert pairs.n_keys == C * (C + 1) // 2
    assert np.array_equal(pairs.key_cams.numpy(), rows * C + cols)
    key_of = {(r, c): k for k, (r, c) in enumerate(zip(rows, cols))}
    key = np.array([key_of[(x, y)] for x, y in zip(cam[a], cam[b])])
    assert np.all(np.diff(key) >= 0)
    same = np.diff(key) == 0
    assert np.all(pt[a][1:][same] >= pt[a][:-1][same])
    vals = np.random.default_rng(2).standard_normal(a.shape[0])
    x = vals
    for lv, cs in enumerate(pairs.pair_levels):
        cs = cs.numpy().astype(np.int64)
        assert cs[0] == 0 and cs[-1] == x.shape[0] and np.all(np.diff(cs) <= kn.CHUNK)
        if lv == 0:  # a chunk never crosses a key
            assert np.all(key[cs[:-1]] == key[cs[1:] - 1])
        x = np.array([x[s:e].sum() for s, e in zip(cs[:-1], cs[1:])])
    first = pairs.pair_level_first.numpy().astype(np.int64)
    assert first.shape == (pairs.n_keys + 1,) and np.all(np.diff(first) <= kn.CHUNK)
    out = np.array([x[s:e].sum() for s, e in zip(first[:-1], first[1:])])
    np.testing.assert_allclose(out, np.bincount(key, vals, minlength=pairs.n_keys),
                               rtol=1e-12, atol=1e-9)


def test_pair_levels_host_arrays_are_built_once_and_follow_the_levels():
    """schur_assembly passes the pair levels as host arrays of their chunk
    counts and device pointers, which the pair plan builds once, as the row
    plan does its levels'; a level that is not int32 is refused."""
    import torch

    pt, cam, P, C = _structure("long_track")
    pairs = fo.build_row_plan(pt, cam, P, C, "cpu", n_cams=C).ensure_pairs()
    levels = pairs.pair_levels
    assert len(levels) == 2  # camera 0 holds ~130,000 pairs of the 600-row point
    assert pairs.pair_level_sizes == tuple(int(s.shape[0]) - 1 for s in levels)
    assert list(pairs.pair_level_counts) == list(pairs.pair_level_sizes)
    assert list(pairs.pair_level_ptrs) == [s.data_ptr() for s in levels]
    with pytest.raises(TypeError, match="pair_levels"):
        dataclasses.replace(pairs, pair_levels=(levels[0].to(torch.int64),))
