"""ceres_tpu_torch.manifolds against ceres_tpu.manifolds (the twin of
tests/test_manifolds.py) for the five manifolds the fused evaluation
takes: plus, minus, both Jacobians and the rows-form PlusJacobian columns
on the same numpy inputs, to 1e-13; and the reference's manifold axioms
on the port alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu import manifolds as jm

from ceres_tpu_torch import manifolds as tm


def _pairs():
    return {
        "Euclidean": (jm.EuclideanManifold(3), tm.EuclideanManifold(3)),
        "Subset": (jm.SubsetManifold(4, [1, 3]), tm.SubsetManifold(4, [1, 3])),
        "Quaternion": (jm.QuaternionManifold(), tm.QuaternionManifold()),
        "EigenQuaternion": (jm.EigenQuaternionManifold(), tm.EigenQuaternionManifold()),
        "ProductQuatEuclidean6": (
            jm.ProductManifold(jm.QuaternionManifold(), jm.EuclideanManifold(6)),
            tm.ProductManifold(tm.QuaternionManifold(), tm.EuclideanManifold(6))),
        "ProductEuclideanEigen": (
            jm.ProductManifold(jm.EuclideanManifold(2), jm.EigenQuaternionManifold()),
            tm.ProductManifold(tm.EuclideanManifold(2), tm.EigenQuaternionManifold())),
    }


NAMES = list(_pairs())
TOL = 1e-13


def _unit_quaternions(name, x):
    """Normalize the quaternion sub-blocks of ambient rows x (..., a)."""
    x = np.array(x)
    spans = {"Quaternion": [(0, 4)], "EigenQuaternion": [(0, 4)],
             "ProductQuatEuclidean6": [(0, 4)], "ProductEuclideanEigen": [(2, 6)]}
    for a, b in spans.get(name, []):
        x[..., a:b] /= np.linalg.norm(x[..., a:b], axis=-1, keepdims=True)
    return x


def _state(name, m, seed):
    rng = np.random.default_rng(seed)
    x = _unit_quaternions(name, rng.standard_normal(m.ambient_size))
    d = rng.standard_normal(m.tangent_size) * 0.3
    return x, d


def _close(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= TOL * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_manifold_matches_jax(name, seed):
    jmf, tmf = _pairs()[name]
    assert (tmf.ambient_size, tmf.tangent_size) == (jmf.ambient_size, jmf.tangent_size)
    assert tmf.batch_key() == jmf.batch_key()
    x, d = _state(name, jmf, seed)
    y = _unit_quaternions(name, np.random.default_rng(seed + 10).standard_normal(
        jmf.ambient_size))
    tx, td, ty = (torch.as_tensor(a) for a in (x, d, y))
    _close(tmf.plus(tx, td), jmf.plus(jnp.asarray(x), jnp.asarray(d)))
    _close(tmf.minus(ty, tx), jmf.minus(jnp.asarray(y), jnp.asarray(x)))
    _close(tmf.plus_jacobian(tx), jmf.plus_jacobian(jnp.asarray(x)))
    _close(tmf.minus_jacobian(tx), jmf.minus_jacobian(jnp.asarray(x)))


@pytest.mark.parametrize("name", NAMES)
def test_plus_jacobian_columns_rows_match_jax(name):
    jmf, tmf = _pairs()[name]
    assert tmf.supports_rows_columns and jmf.supports_rows_columns
    rows = 7
    X = _unit_quaternions(name, np.random.default_rng(11).standard_normal(
        (rows, jmf.ambient_size))).T
    out = tmf.plus_jacobian_columns_rows(torch.as_tensor(X))
    ref = jmf.plus_jacobian_columns_rows(jnp.asarray(X))
    assert len(out) == len(ref) == tmf.tangent_size
    for o, r in zip(out, ref):
        _close(o, r)
    # and they are the columns of plus_jacobian, row by row
    pj = torch.func.vmap(tmf.plus_jacobian)(torch.as_tensor(X.T))
    _close(torch.stack(out, dim=-1).permute(1, 0, 2), pj)


@pytest.mark.parametrize("name", NAMES)
def test_batched_plus_and_plus_jacobian_match_jax(name):
    """torch.func.vmap over blocks, as CompiledProgram batches a family."""
    jmf, tmf = _pairs()[name]
    rng = np.random.default_rng(5)
    X = _unit_quaternions(name, rng.standard_normal((9, jmf.ambient_size)))
    D = rng.standard_normal((9, jmf.tangent_size)) * 0.2
    _close(torch.func.vmap(tmf.plus)(torch.as_tensor(X), torch.as_tensor(D)),
           jax.vmap(jmf.plus)(jnp.asarray(X), jnp.asarray(D)))
    _close(torch.func.vmap(tmf.plus_jacobian)(torch.as_tensor(X)),
           jax.vmap(jmf.plus_jacobian)(jnp.asarray(X)))


@pytest.mark.parametrize("name", NAMES)
def test_axioms(name):
    """Plus(x, 0) = x, Minus(Plus(x, d), x) = d, PlusJacobian and
    MinusJacobian are the derivatives of plus and minus, and
    MinusJacobian PlusJacobian = I (manifold_test_utils.h)."""
    _, m = _pairs()[name]
    x, d = (torch.as_tensor(a) for a in _state(name, m, 4))
    zero = torch.zeros(m.tangent_size, dtype=torch.float64)
    torch.testing.assert_close(m.plus(x, zero), x, rtol=0, atol=1e-12)
    torch.testing.assert_close(m.minus(m.plus(x, d), x), d, rtol=0, atol=1e-9)
    P = m.plus_jacobian(x)
    M = m.minus_jacobian(x)
    torch.testing.assert_close(P, torch.func.jacfwd(lambda t: m.plus(x, t))(zero),
                               rtol=0, atol=1e-9)
    torch.testing.assert_close(M, torch.func.jacfwd(lambda y: m.minus(y, x))(x),
                               rtol=0, atol=1e-9)
    torch.testing.assert_close(M @ P, torch.eye(m.tangent_size, dtype=torch.float64),
                               rtol=0, atol=1e-9)


def test_quaternion_plus_preserves_norm_and_subset_holds_constants():
    m = tm.QuaternionManifold()
    x = torch.as_tensor(_state("Quaternion", m, 5)[0])
    y = m.plus(x, torch.tensor([0.3, -1.2, 0.8], dtype=torch.float64))
    assert abs(float(torch.linalg.vector_norm(y)) - 1.0) < 1e-12
    s = tm.SubsetManifold(4, [0, 2])
    y = s.plus(torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64),
               torch.tensor([10.0, 20.0], dtype=torch.float64))
    assert y.tolist() == [1.0, 12.0, 3.0, 24.0]
    with pytest.raises(ValueError, match="out of range"):
        tm.SubsetManifold(3, [3])


# -- SphereManifold, LineManifold and AutoDiffManifold (the host loop's
# -- slice): no rows form, so a program with one takes the flat path

def _autodiff_pair():
    return (jm.AutoDiffManifold(lambda x, d: x * jnp.exp(d),
                                lambda y, x: jnp.log(y / x), 2, 2),
            tm.AutoDiffManifold(lambda x, d: x * torch.exp(d),
                                lambda y, x: torch.log(y / x), 2, 2))


HOST_PAIRS = {
    "Sphere4": (jm.SphereManifold(4), tm.SphereManifold(4)),
    "Sphere3": (jm.SphereManifold(3), tm.SphereManifold(3)),
    "Line3": (jm.LineManifold(3), tm.LineManifold(3)),
    "Line2": (jm.LineManifold(2), tm.LineManifold(2)),
    "AutoDiff": _autodiff_pair(),
}


def _host_state(name, m, seed):
    """x on the manifold (unit sphere point, unit line direction, positive
    AutoDiff coordinates), a tangent d, and a y near x."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(m.ambient_size)
    if name.startswith("Sphere"):
        x /= np.linalg.norm(x)
    elif name.startswith("Line"):
        n = m.ambient_size // 2
        x[n:] /= np.linalg.norm(x[n:])
    else:
        x = np.abs(x) + 0.5
    d = rng.standard_normal(m.tangent_size) * 0.3
    return x, d


_JAX_ALL = {}


def _jax_all(name):
    """One jitted JAX function per manifold: (plus, minus, PlusJacobian,
    MinusJacobian) at (x, d, y), compiled once for all seeds."""
    if name not in _JAX_ALL:
        m = HOST_PAIRS[name][0]
        _JAX_ALL[name] = jax.jit(lambda x, d, y: (m.plus(x, d), m.minus(y, x),
                                                  m.plus_jacobian(x), m.minus_jacobian(x)))
    return _JAX_ALL[name]


@pytest.mark.parametrize("name", list(HOST_PAIRS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_loop_manifolds_match_jax(name, seed):
    """plus, minus and both Jacobians on the same numpy inputs, 1e-12
    relative to the values' scale; the pivot of the Householder frame on
    both of its branches (x_last > 0 and < 0 over the seeds) and at the
    pole (x = e_last, the trivial branch)."""
    jmf, tmf = HOST_PAIRS[name]
    assert (tmf.ambient_size, tmf.tangent_size) == (jmf.ambient_size, jmf.tangent_size)
    assert not tmf.supports_rows_columns
    x, d = _host_state(name, jmf, seed)
    y = np.array(_jax_all(name)(jnp.asarray(x), jnp.asarray(d * 0.5), jnp.asarray(x))[0])
    points = [x]
    if name.startswith("Sphere"):
        pole = np.zeros(jmf.ambient_size)
        pole[-1] = 1.0
        points.append(pole)
    for x in points:
        tx, td, ty = (torch.as_tensor(a) for a in (x, d, y))
        jx, jd, jy = (jnp.asarray(a) for a in (x, d, y))
        refs = _jax_all(name)(jx, jd, jy)
        outs = (tmf.plus(tx, td), tmf.minus(ty, tx), tmf.plus_jacobian(tx),
                tmf.minus_jacobian(tx))
        for out, ref in zip(outs, refs):
            out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
            assert out.shape == ref.shape
            assert np.abs(out - ref).max() <= 1e-12 * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("name", list(HOST_PAIRS))
def test_host_loop_manifold_axioms_and_batching(name):
    """Plus(x, 0) = x, Minus(Plus(x, d), x) = d, MinusJacobian
    PlusJacobian = I, and torch.func.vmap over blocks as the program
    batches a family (1e-12 against the JAX vmap)."""
    jmf, m = HOST_PAIRS[name]
    x, d = (torch.as_tensor(a) for a in _host_state(name, m, 4))
    zero = torch.zeros(m.tangent_size, dtype=torch.float64)
    torch.testing.assert_close(m.plus(x, zero), x, rtol=0, atol=1e-12)
    torch.testing.assert_close(m.minus(m.plus(x, d), x), d, rtol=0, atol=1e-9)
    torch.testing.assert_close(m.minus_jacobian(x) @ m.plus_jacobian(x),
                               torch.eye(m.tangent_size, dtype=torch.float64),
                               rtol=0, atol=1e-9)
    X = np.stack([_host_state(name, m, s)[0] for s in range(6)])
    D = np.stack([_host_state(name, m, s)[1] for s in range(6)])
    refs = jax.jit(jax.vmap(lambda x, d: (jmf.plus_jacobian(x), jmf.plus(x, d))))(
        jnp.asarray(X), jnp.asarray(D))
    outs = (torch.func.vmap(m.plus_jacobian)(torch.as_tensor(X)),
            torch.func.vmap(m.plus)(torch.as_tensor(X), torch.as_tensor(D)))
    for out, ref in zip(outs, refs):
        out, ref = out.numpy(), np.asarray(ref)
        assert np.abs(out - ref).max() <= 1e-12 * max(np.abs(ref).max(), 1.0)
