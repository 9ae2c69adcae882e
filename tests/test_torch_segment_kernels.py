"""The plain versions of the flat Schur path's four kernels
(ceres_tpu_torch.ops.kernels: segment_block_sum, segment_block_expand,
segment_spread_sum, unsorted_segment_sum) against the JAX package's Pallas
kernels in interpret mode, as tests/test_pallas_kernels.py runs them, in
float32 on inputs from numpy seeds. Tolerances, relative to the largest
entry of the reference: 1e-5 for the segment sums (the Pallas kernels sum
a 3-way bf16 split of the float32 values on the MXU, the plain versions in
float32 in another order), 2e-5 for the spread sum (a 2-way split, as
tests/test_pallas_kernels.py:81), exact for the gather. In float64 each
plain version is held against np.add.at or np.take to 1e-12."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu.ops import pallas_kernels as pk

from ceres_tpu_torch.ops import flatops as fo
from ceres_tpu_torch.ops import kernels as kn

# (number of blocks, rows, how the rows pick their block)
SORTED_CASES = [
    (300, 1200, "random"),  # some blocks own no row: they come out zero
    (40, 500, "sentinel"),  # the last id is the sentinel nv of the flat plans
    (1, 5000, "one"),  # one block holds every row: a two-level plan
]


def _sorted_ids(nb, n, how, rng):
    if how == "one":
        return np.zeros(n, np.int32)
    ids = np.sort(rng.integers(0, nb, n))
    if how == "sentinel":
        ids[-7:] = nb - 1
    return ids.astype(np.int32)


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("w", [3, 9, 80])
@pytest.mark.parametrize("nb,n,how", SORTED_CASES)
def test_segment_block_sum_plain_matches_pallas(nb, n, how, w):
    rng = np.random.default_rng(nb + n + w)
    ids = _sorted_ids(nb, n, how, rng)
    x = rng.standard_normal((n, w)).astype(np.float32)
    ts, max_rows = pk.plan_block_tiles(ids, nb)
    ref = np.asarray(pk.segment_block_sum(jnp.asarray(x), jnp.asarray(ids),
                                          jnp.asarray(ts), nb, max_rows=max_rows,
                                          interpret=True))[:nb]
    plan = fo.build_segment_plan(ids, nb, "cpu")
    assert plan.order is None
    if how == "one":
        assert plan.level_sizes == (-(-n // kn.CHUNK), 2)
    out = kn.segment_block_sum(torch.as_tensor(x), plan).numpy()
    assert _rel(out, ref) <= 1e-5
    empty = np.bincount(ids, minlength=nb) == 0
    assert np.all(out[empty] == 0)


@pytest.mark.parametrize("w", [3, 9, 80])
def test_unsorted_segment_sum_plain_matches_windowed_pallas(w):
    """900 cameras (past the 257 blocks where the JAX package takes its
    windows), ids with camera locality, as rows sorted by point give; two
    rows carry the sentinel, which the Pallas kernel drops and the flat
    plans keep as key C."""
    rng = np.random.default_rng(w)
    n, C = 5000, 900
    ids = np.clip((np.arange(n) / n * C).astype(np.int64) + rng.integers(-30, 30, n),
                  0, C - 1).astype(np.int32)
    ids[[3, 100]] = C
    x = rng.standard_normal((n, w)).astype(np.float32)
    windows = pk.plan_fixed_windows(ids, C, width_cap=256)
    ref = np.asarray(pk.windowed_segment_sum(jnp.asarray(x), jnp.asarray(ids), C,
                                             windows, interpret=True))[:C, :w]
    plan = fo.build_segment_plan(ids, C + 1, "cpu")
    assert plan.order is not None
    out = kn.unsorted_segment_sum(torch.as_tensor(x), plan).numpy()
    assert _rel(out[:C], ref) <= 1e-5
    np.testing.assert_allclose(out[C], x[[3, 100]].sum(0), rtol=1e-6)


@pytest.mark.parametrize("t", [3, 9, 80])
def test_segment_block_expand_plain_matches_pallas(t):
    """Exact: each output row is one table row, the sentinel's zero."""
    rng = np.random.default_rng(t)
    nb, n = 129, 600
    ids = _sorted_ids(nb + 1, n, "sentinel", rng)
    vals = rng.standard_normal((nb + 1, t)).astype(np.float32)
    vals[nb] = 0.0
    ts, max_rows = pk.plan_block_tiles(ids, nb + 1)
    ref = np.asarray(pk.segment_block_expand(jnp.asarray(vals), jnp.asarray(ids),
                                             jnp.asarray(ts), n, max_rows=max_rows,
                                             interpret=True))
    out = kn.segment_block_expand(torch.as_tensor(vals), torch.as_tensor(ids)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("P,C,te,tf", [(37, 5, 3, 9), (60, 16, 3, 6), (60, 1, 3, 8)])
def test_segment_spread_sum_plain_matches_pallas(P, C, te, tf):
    """The BA shape of tests/test_pallas_kernels.py:56, and the libmv
    model's two camera-side slots (cameras 6 wide, the one shared
    intrinsics block 8 wide); a row of a constant camera (id C) adds
    nothing."""
    rng = np.random.default_rng(P + C)
    n = 400
    pt = np.sort(rng.integers(0, P, n)).astype(np.int32)
    cam = rng.integers(0, C, n).astype(np.int32)
    cam[5] = C
    Y = rng.standard_normal((n, te * tf)).astype(np.float32)
    ts, max_rows = pk.plan_block_tiles(pt, P)
    ref = np.asarray(pk.segment_spread_sum(jnp.asarray(Y), jnp.asarray(cam),
                                           jnp.asarray(pt), jnp.asarray(ts), P, C,
                                           te, tf, max_rows=max_rows,
                                           interpret=True))[:P]
    pt_start = np.concatenate([[0], np.cumsum(np.bincount(pt, minlength=P))])
    out = kn.segment_spread_sum(torch.as_tensor(Y), torch.as_tensor(cam),
                                torch.as_tensor(pt_start.astype(np.int32)), C, te, tf)
    assert _rel(out.numpy(), ref) <= 2e-5


@pytest.mark.parametrize("how", ["random", "sentinel", "one", "unsorted"])
def test_plain_versions_float64_against_numpy(how):
    """Each plain version in float64 against np.add.at / np.take, 1e-12
    relative to the largest entry."""
    rng = np.random.default_rng(11)
    nb, n, w = 50, 3000, 7
    if how == "unsorted":
        ids = rng.integers(0, nb, n).astype(np.int32)
    else:
        ids = _sorted_ids(nb, n, how, rng)
    x = rng.standard_normal((n, w))
    ref = np.zeros((nb, w))
    np.add.at(ref, ids, x)
    plan = fo.build_segment_plan(ids, nb, "cpu")
    red = kn.unsorted_segment_sum if how == "unsorted" else kn.segment_block_sum
    assert _rel(red(torch.as_tensor(x), plan).numpy(), ref) <= 1e-12
    vals = rng.standard_normal((nb, w))
    out = kn.segment_block_expand(torch.as_tensor(vals), torch.as_tensor(ids))
    np.testing.assert_array_equal(out.numpy(), np.take(vals, ids, axis=0))
    if how == "unsorted":
        return
    C, te, tf = 4, 3, 2
    cam = rng.integers(0, C, n)
    Y = rng.standard_normal((n, te * tf))
    A = np.zeros((nb, te, C, tf))
    np.add.at(A, (ids, slice(None), cam), Y.reshape(n, te, tf))
    out = kn.segment_spread_sum(torch.as_tensor(Y), torch.as_tensor(cam.astype(np.int32)),
                                plan.seg_start, C, te, tf)
    assert _rel(out.numpy(), A.reshape(nb, -1)) <= 1e-12


def test_segment_plan_levels_cover_every_row_once():
    """The chunk plans: every level's chunks tile its items in key order,
    no chunk crosses a key or holds more than CHUNK items, and the last
    level leaves each key at most CHUNK chunks."""
    rng = np.random.default_rng(2)
    ids = np.concatenate([np.zeros(9000, np.int64), rng.integers(1, 30, 700)])
    rng.shuffle(ids)
    plan = fo.build_segment_plan(ids, 31, "cpu")
    order = plan.order.numpy()
    assert np.all(np.sort(ids, kind="stable") == ids[order])
    keys = ids[order]
    for lv, starts in enumerate(plan.level_starts):
        cs = starts.numpy()
        assert cs[0] == 0 and cs[-1] == len(keys)
        sizes = np.diff(cs)
        assert np.all((sizes >= 1) & (sizes <= kn.CHUNK))
        first = keys[cs[:-1]]
        assert np.all(keys[cs[1:] - 1] == first)  # one key per chunk
        keys = first  # the next level's items are this level's chunks
    kf = plan.key_first.numpy()
    assert kf[-1] == len(keys) and np.diff(kf).max() <= kn.CHUNK
    assert np.all(np.diff(kf) == np.bincount(keys, minlength=31))
