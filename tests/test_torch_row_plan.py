"""The row plan's fields for isc_matvec's point and camera passes
(ops/flatops.build_row_plan): each row's place in camera order, the point
blocks and the camera sum's tree of levels, on structures with a long
track, points without rows and a camera of thousands of rows."""
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
    plan = fo.build_row_plan(pt, cam, P, C, "cpu")
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
    plan = fo.build_row_plan(pt, cam, P, C, "cpu")
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
    plan = fo.build_row_plan(pt, cam, P, C, "cpu")
    assert plan.cam_levels[0] is plan.cam_chunk_start
    assert plan.cam_level_sizes[0] == plan.n_cam_chunks
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
    plan = fo.build_row_plan(pt, cam, P, C, "cpu")
    levels = plan.cam_levels
    assert plan.cam_level_sizes == tuple(int(s.shape[0]) - 1 for s in levels)
    assert list(plan.cam_level_counts) == list(plan.cam_level_sizes)
    assert list(plan.cam_level_ptrs) == [s.data_ptr() for s in levels]
    cut = dataclasses.replace(plan, cam_levels=levels[:1])
    assert list(cut.cam_level_counts) == [plan.cam_level_sizes[0]]
    assert list(cut.cam_level_ptrs) == [levels[0].data_ptr()]
    with pytest.raises(TypeError, match="cam_levels"):
        dataclasses.replace(plan, cam_levels=(levels[0].to(torch.int64),))
