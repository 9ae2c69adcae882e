"""The port's cubic interpolation (ceres_tpu_torch/cubic_interpolation.py)
against the JAX package's on the CPU: the twins of
tests/test_satellite_apis.py's three interpolation tests, and the
Jacobian of interpolated residuals through vmap(jacfwd(...)) over a batch
of blocks, as AutoDiffCostFunction takes it, against the JAX Jacobian."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd, vmap

import ceres_tpu as ct

import ceres_tpu_torch as ctt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_cubic_interpolator_reproduces_quadratic():
    """The Catmull-Rom kernel reproduces polynomials up to degree 2 away
    from the edges (1e-10), and its autodiff derivative the analytic one."""
    xs = np.arange(10.0)
    f = lambda x: 0.5 * x**2 - x + 3.0  # noqa: E731
    interp = ctt.CubicInterpolator(ctt.Grid1D(f(xs)))
    for x in [2.5, 3.25, 6.75]:
        np.testing.assert_allclose(float(interp(x)), f(x), rtol=1e-10)
    x = torch.tensor(4.5, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(interp(x), x)
    np.testing.assert_allclose(float(g), 4.5 - 1.0, rtol=1e-10)
    assert float(jacfwd(interp)(torch.tensor(4.5, dtype=torch.float64))) == pytest.approx(
        3.5, rel=1e-10)


def test_bicubic_interpolator_linear_exact():
    r, c = np.meshgrid(np.arange(8.0), np.arange(9.0), indexing="ij")
    vals = 2 * r + 3 * c + 1
    interp = ctt.BiCubicInterpolator(ctt.Grid2D(vals))
    np.testing.assert_allclose(float(interp(3.3, 4.7)), 2 * 3.3 + 3 * 4.7 + 1, rtol=1e-10)
    r0 = torch.tensor(3.3, dtype=torch.float64, requires_grad=True)
    (gr,) = torch.autograd.grad(interp(r0, 4.7), r0)
    np.testing.assert_allclose(float(gr), 2.0, atol=1e-10)


def test_interpolated_cost_function():
    """Sampled data inside an autodiff cost: sin(x / 3) = 1 at 3 pi / 2,
    within the interpolation's error (0.05); the port's answer equals the
    JAX package's within 1e-10."""
    xs = np.arange(20.0)
    data = np.sin(xs / 3.0)
    answers = []
    for pkg, xp in ((ct, jnp), (ctt, torch)):
        interp = pkg.CubicInterpolator(pkg.Grid1D(data))
        x = np.asarray([2.0])
        p = pkg.Problem()
        p.add_residual_block(
            pkg.AutoDiffCostFunction(lambda v: xp.atleast_1d(interp(v[0]) - 1.0), 1, [1]),
            None, [x])
        kw = {} if pkg is ct else {"device": "cpu"}
        pkg.solve(pkg.Options(max_num_iterations=100), p, **kw)
        answers.append(x[0])
    assert abs(answers[1] - 3 * np.pi / 2) < 0.05
    np.testing.assert_allclose(answers[1], answers[0], rtol=0, atol=1e-10)


@pytest.mark.parametrize("dim", [1, 2])
def test_batched_jacobian_matches_jax(dim):
    """r(s) = [f(s0), f(s1 + 0.5 s0), g(s0, s1)]: a 1-D and a 2-D
    interpolator of `dim` values a cell, at 64 blocks spread over the grids
    and past their edges (clamped), differentiated by vmap(jacfwd) as
    AutoDiffCostFunction does; residuals and Jacobians within 1e-12 of
    jax.vmap(jax.jacfwd) of the JAX interpolators."""
    rng = np.random.default_rng(7)
    v1 = rng.standard_normal((12,) if dim == 1 else (12, dim))
    v2 = rng.standard_normal((7, 9) if dim == 1 else (7, 9, dim))
    s = np.stack([rng.uniform(-2.0, 13.0, 64), rng.uniform(-2.0, 10.0, 64)], 1)

    def residual(pkg, xp):
        f = pkg.CubicInterpolator(pkg.Grid1D(v1))
        g = pkg.BiCubicInterpolator(pkg.Grid2D(v2))

        def r(b):
            return xp.concatenate([xp.atleast_1d(f(b[0])),
                                   xp.atleast_1d(f(b[1] + 0.5 * b[0])),
                                   xp.atleast_1d(g(b[0] * 0.5, b[1]))])
        return r

    rj = residual(ct, jnp)
    rt = residual(ctt, torch)
    st = torch.as_tensor(s)
    out_j = np.asarray(jax.vmap(rj)(jnp.asarray(s)))
    jac_j = np.asarray(jax.vmap(jax.jacfwd(rj))(jnp.asarray(s)))
    out_t = vmap(rt)(st).numpy()
    jac_t = vmap(jacfwd(rt))(st).numpy()
    assert jac_t.shape == (64, 3 * dim, 2)
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(jac_t, jac_j, rtol=0, atol=1e-12)
