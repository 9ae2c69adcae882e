"""The Jc form of segment_spread_sum (TPU kernel 8J): the plain version of
ceres_tpu_torch.ops.kernels.segment_spread_sum with Jc, which returns the
dense-Schur A and the camera Gram blocks F'F, against the JAX package's
Pallas kernel in interpret mode (as tests/test_pallas_kernels.py:228 runs
it) in float32, and against np.add.at in float64, on inputs from numpy
seeds. Tolerances, relative to the largest entry of the reference: 2e-5
against the Pallas kernel (it sums hi/lo bf16 halves of the float32 values
on the MXU), 1e-12 in float64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu.ops import pallas_kernels as pk

from ceres_tpu_torch.ops import kernels as kn


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-300)


def _rows(P, C, B, r, te, tf, dtype, seed):
    """Rows sorted by point, random cameras with one row of the constant
    camera C, Y (B, te*tf) and Jc (B, r*tf)."""
    rng = np.random.default_rng(seed)
    pt = np.sort(rng.integers(0, P, B)).astype(np.int32)
    cam = rng.integers(0, C, B).astype(np.int32)
    cam[5] = C
    Y = rng.standard_normal((B, te * tf)).astype(dtype)
    Jc = rng.standard_normal((B, r * tf)).astype(dtype)
    pt_start = np.concatenate([[0], np.cumsum(np.bincount(pt, minlength=P))])
    return pt, cam, Y, Jc, pt_start.astype(np.int32)


@pytest.mark.parametrize("P,C,B,te,tf", [(40, 5, 300, 3, 9), (30, 4, 200, 3, 6)])
def test_spread_ftf_plain_matches_pallas(P, C, B, te, tf):
    """The BA shape of the specialized pipeline (tp = 3, tc = 9, r = 2)
    and a narrower camera block (the libmv cameras, 6 wide)."""
    r = 2
    pt, cam, Y, Jc, pt_start = _rows(P, C, B, r, te, tf, np.float32, P + C)
    ts, max_rows = pk.plan_block_tiles(pt, P)
    A_ref, ftf_ref = pk.segment_spread_sum(
        jnp.asarray(Y), jnp.asarray(cam), jnp.asarray(pt), jnp.asarray(ts), P, C,
        te, tf, max_rows=max_rows, interpret=True, Jc=jnp.asarray(Jc), r=r)
    kn.reset_counts()
    A, ftf = kn.segment_spread_sum(torch.as_tensor(Y), torch.as_tensor(cam),
                                   torch.as_tensor(pt_start), C, te, tf,
                                   Jc=torch.as_tensor(Jc), r=r)
    assert kn.segment_spread_ftf.plain_calls == 1
    assert A.shape == (P, te * C * tf) and ftf.shape == (C, tf * tf)
    assert A.dtype == ftf.dtype == torch.float32
    assert _rel(A.numpy(), np.asarray(A_ref)[:P]) <= 2e-5
    assert _rel(ftf.numpy(), np.asarray(ftf_ref)) <= 2e-5


@pytest.mark.parametrize("r", [1, 2, 3])
def test_spread_ftf_plain_float64_against_numpy(r):
    """A and F'F against np.add.at to 1e-12; the constant camera's row adds
    nothing to either, and a point without rows gets a zero slab."""
    P, C, B, te, tf = 50, 4, 400, 3, 5
    pt, cam, Y, Jc, pt_start = _rows(P, C, B, r, te, tf, np.float64, r)
    A, ftf = kn.segment_spread_sum(torch.as_tensor(Y), torch.as_tensor(cam),
                                   torch.as_tensor(pt_start), C, te, tf,
                                   Jc=torch.as_tensor(Jc), r=r)
    live = cam < C
    A_ref = np.zeros((P, te, C, tf))
    np.add.at(A_ref, (pt[live], slice(None), cam[live]), Y[live].reshape(-1, te, tf))
    J = Jc.reshape(B, r, tf)
    ftf_ref = np.zeros((C, tf, tf))
    np.add.at(ftf_ref, cam[live], np.einsum("bqi,bqj->bij", J[live], J[live]))
    assert _rel(A.numpy(), A_ref.reshape(P, -1)) <= 1e-12
    assert _rel(ftf.numpy(), ftf_ref.reshape(C, -1)) <= 1e-12
    empty = np.bincount(pt, minlength=P) == 0
    assert np.all(A.numpy()[empty] == 0)
    # the form without Jc gives the same A
    A8 = kn.segment_spread_sum(torch.as_tensor(Y), torch.as_tensor(cam),
                               torch.as_tensor(pt_start), C, te, tf)
    np.testing.assert_array_equal(A8.numpy(), A.numpy())
