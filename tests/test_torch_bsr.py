"""The port's block-Jacobian operators against ceres_tpu.ops.bsr (the
twins of tests/test_bsr.py) on the CPU. The port's counterparts of the
JAX functions J v, J'u, diag(J'J), column scaling, the block-Jacobi
blocks of J'J + D^2 and their inverse are ops/flatops.FlatJacobianOps's
(the CGNR step's, over kernels 6, 7 and 9), held here against the JAX
functions on the JAX package's block Jacobian of a small BAL problem built
one block at a time, with camera 0 held constant (the sentinel column).
Each tolerance is stated where it is used."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu.models import bal as jbal
from ceres_tpu.ops import bsr as jbsr
from ceres_tpu.program import CompiledProgram as JaxProgram

from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.ops import bsr
from ceres_tpu_torch.ops import flatops as fo
from ceres_tpu_torch.program import CompiledProgram

TOL = 1e-12


def _bal():
    b = jbal.synthetic_bal(num_cameras=4, num_points=40, visibility=0.5, noise=0.3, seed=5)
    return jbal.perturb(b, rotation_sigma=0.05, translation_sigma=0.2, point_sigma=0.2)


@pytest.fixture(scope="module")
def setup():
    """(JAX meta, JAX values, port meta, the port's FlatJacobianOps and
    the same values flattened as torch tensors, dense J, tangent size) of
    one evaluation."""
    b = _bal()
    jp, jcams, _ = jbal.build_problem(b)
    jp.set_parameter_block_constant(jcams[0])
    jprog = JaxProgram(jp, sort_rows=True)
    _, _, _, jvalues = jprog.evaluate_bsr(jprog.initial_state())
    jmeta = jbsr.build_meta(jprog)
    tp, tcams, _ = tbal.build_problem(tbal.from_arrays(
        b.cameras, b.points, b.camera_index, b.point_index, b.observations))
    tp.set_parameter_block_constant(tcams[0])
    meta = bsr.build_meta(CompiledProgram(tp, device="cpu"))
    flat = fo.FlatJacobianOps(meta, "cpu")
    vflat = flat.flatten([[torch.as_tensor(np.array(V)) for V in slots] for slots in jvalues])
    J = np.asarray(jbsr.to_dense(jmeta, jvalues))
    return jmeta, jvalues, meta, (flat, vflat), J, jmeta.tangent_size


def _close(out, ref, tol=TOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1.0)


def test_meta_matches_jax(setup):
    """The same kinds, families and per-row block ids (the constant
    camera's rows carrying the sentinel id)."""
    jmeta, _, meta, _, _, T = setup
    assert meta.tangent_size == T and meta.num_rows == jmeta.num_rows
    assert sum(f.num_var for f in meta.families) == jmeta.num_var_blocks
    assert [(f.tangent_offset, f.num_var, f.t, f.block_id_offset) for f in meta.families] == [
        (f.tangent_offset, f.num_var, f.t, f.block_id_offset) for f in jmeta.families]
    for k, jk in zip(meta.kinds, jmeta.kinds):
        assert (k.row_offset, k.B, k.r) == (jk.row_offset, jk.B, jk.r)
        for s, js in zip(k.slots, jk.slots):
            np.testing.assert_array_equal(s.block_ids, jmeta.arrays[js.block_id_key])


@pytest.mark.parametrize("op", ["right", "left", "sqn", "scale"])
def test_products_match_jax_and_dense(setup, op):
    """J v, J'u, diag(J'J) and J diag(s) v, 1e-12 relative against the
    JAX function on the same values and against the dense J."""
    jmeta, jvalues, meta, (flat, vflat), J, T = setup
    rng = np.random.default_rng(1)
    v = rng.standard_normal(T)
    u = rng.standard_normal(J.shape[0])
    if op == "right":
        out = flat.right(vflat, torch.as_tensor(v))
        ref, dense = jbsr.right_multiply(jmeta, jvalues, jnp.asarray(v)), J @ v
    elif op == "left":
        out = flat.left(vflat, torch.as_tensor(u))
        ref, dense = jbsr.left_multiply(jmeta, jvalues, jnp.asarray(u)), J.T @ u
    elif op == "sqn":
        out = flat.gradient_and_norms(vflat, torch.as_tensor(u))[1]
        ref, dense = jbsr.squared_column_norm(jmeta, jvalues), (J * J).sum(axis=0)
    else:
        s = rng.uniform(0.5, 2.0, T)
        out = flat.right(flat.scale_columns(vflat, torch.as_tensor(s)), torch.as_tensor(v))
        ref = jbsr.right_multiply(jmeta, jbsr.scale_columns(jmeta, jvalues, jnp.asarray(s)),
                                  jnp.asarray(v))
        dense = (J * s[None, :]) @ v
    _close(out, ref)
    _close(out, dense)


def test_block_diag_jtj_and_inverse_match_jax(setup):
    """The blocks of J'J per family, plus D^2, against the JAX function
    and the dense product, 1e-12; their inverse applied to a vector
    against the JAX package's Cholesky solves, 1e-12."""
    jmeta, jvalues, meta, (flat, vflat), J, T = setup
    D = np.random.default_rng(2).uniform(0.3, 1.0, T)
    blocks = flat.block_jtj_all(vflat)
    jblocks = jbsr.block_diag_jtj(jmeta, jvalues, jnp.asarray(D))
    A = J.T @ J + np.diag(D * D)
    for f, blk, jblk in zip(meta.families, blocks, jblocks):
        d2 = (D[f.tangent_offset:f.tangent_offset + f.num_var * f.t] ** 2).reshape(f.num_var, f.t)
        blk = blk.reshape(f.num_var, f.t, f.t) + torch.diag_embed(torch.as_tensor(d2))
        _close(blk, jblk)
        for i in range(f.num_var):
            o = f.tangent_offset + i * f.t
            _close(blk[i], A[o:o + f.t, o:o + f.t])
    v = np.random.default_rng(4).standard_normal(T)
    out = flat.apply_inverse_rows(flat.fams, flat.inverse_flats(flat.fams, blocks,
                                                                torch.as_tensor(D)),
                                  torch.as_tensor(v))
    ref = jbsr.apply_block_diag_inverse(jmeta, jbsr.factorize_block_diag(jblocks),
                                        jnp.asarray(v))
    _close(out, ref)


@pytest.mark.parametrize("t", [2, 3])
def test_indefinite_block_inverts_to_nan(t):
    """A block that is not positive definite inverts to NaN, without
    raising (t = 3 in closed form, other widths by a batched Cholesky):
    the step goes non-finite and the loop rejects it."""
    bad = -np.eye(t)
    bad[0, 0] = 1.0
    blk = torch.as_tensor(np.stack([bad, 2.0 * np.eye(t)]).reshape(2, t * t))
    inv = fo.spd_inverse_flat(blk, t)
    assert torch.isnan(inv[0]).any() and torch.isfinite(inv[1]).all()
