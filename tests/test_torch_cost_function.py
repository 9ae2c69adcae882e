"""The cost functions of the port against ceres_tpu's: the
twins of tests/test_cost_function.py, each Jacobian method against the
JAX package's on the same inputs, and each cost function batched over a
kind (torch.func.vmap) inside a solve. Each tolerance is stated where it
is used."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
import ceres_tpu_torch as ctt
from ceres_tpu_torch.cost_function import (
    AnalyticCostFunction,
    AutoDiffCostFunction,
    ConditionedCostFunction,
    NormalPrior,
    NumericDiffCostFunction,
    cost_function_to_functor,
)


def _functor(a, b):
    return torch.stack([a[0] * b[0] + a[1] * torch.sin(b[1]),
                        torch.exp(0.1 * a[2]) - b[0] * b[1]])


def _jfunctor(a, b):
    return jnp.stack([a[0] * b[0] + a[1] * jnp.sin(b[1]),
                      jnp.exp(0.1 * a[2]) - b[0] * b[1]])


PARAMS = [np.asarray([1.0, 2.0, 3.0]), np.asarray([0.5, -0.7])]


def _t(ps):
    return [torch.as_tensor(p) for p in ps]


def test_autodiff_jacobians_match_numeric_central():
    r1, j1 = AutoDiffCostFunction(_functor, 2, [3, 2]).residuals_and_jacobians(_t(PARAMS))
    r2, j2 = NumericDiffCostFunction(_functor, 2, [3, 2], method="CENTRAL"
                                     ).residuals_and_jacobians(_t(PARAMS))
    np.testing.assert_allclose(r1, r2, atol=1e-14)
    for a, b in zip(j1, j2):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_numeric_forward_less_accurate_than_central():
    _, j_ad = AutoDiffCostFunction(_functor, 2, [3, 2]).residuals_and_jacobians(_t(PARAMS))
    _, j_f = NumericDiffCostFunction(_functor, 2, [3, 2], method="FORWARD"
                                     ).residuals_and_jacobians(_t(PARAMS))
    _, j_c = NumericDiffCostFunction(_functor, 2, [3, 2], method="CENTRAL"
                                     ).residuals_and_jacobians(_t(PARAMS))
    err_f = max(float(torch.max(torch.abs(a - b))) for a, b in zip(j_ad, j_f))
    err_c = max(float(torch.max(torch.abs(a - b))) for a, b in zip(j_ad, j_c))
    assert err_c < err_f < 1e-4


def test_ridders_high_accuracy():
    def stiff(x):
        return torch.exp(5.0 * x[0:1])

    p = [torch.tensor([1.0], dtype=torch.float64)]
    _, j_ad = AutoDiffCostFunction(stiff, 1, [1]).residuals_and_jacobians(p)
    _, j_r = NumericDiffCostFunction(stiff, 1, [1], method="RIDDERS"
                                     ).residuals_and_jacobians(p)
    np.testing.assert_allclose(j_r[0], j_ad[0], rtol=1e-9)


def test_analytic_cost_function():
    class MyCost(AnalyticCostFunction):
        num_residuals = 1
        parameter_block_sizes = (2,)

        def residuals(self, params, data=None):
            x = params[0]
            return torch.stack([x[0] * x[0] + 3.0 * x[1]])

        def jacobians(self, params, data=None):
            x = params[0]
            return [torch.stack([2.0 * x[0], torch.ones_like(x[0]) * 3.0])[None]]

    p = _t([np.asarray([1.5, -2.0])])
    r1, j1 = MyCost().residuals_and_jacobians(p)
    r2, j2 = AutoDiffCostFunction(lambda x: torch.stack([x[0] * x[0] + 3.0 * x[1]]), 1,
                                  [2]).residuals_and_jacobians(p)
    np.testing.assert_allclose(r1, r2)
    np.testing.assert_allclose(j1[0], j2[0])


def test_normal_prior():
    A = np.asarray([[1.0, 0.5], [0.0, 2.0]])
    b = np.asarray([1.0, -1.0])
    x = np.asarray([2.0, 3.0])
    r = NormalPrior(A, b).residuals([torch.as_tensor(x)])
    np.testing.assert_allclose(r, A @ (x - b))


def test_cost_function_to_functor_nesting():
    f = cost_function_to_functor(AutoDiffCostFunction(lambda x: x[0:1] ** 2, 1, [1]))
    outer = AutoDiffCostFunction(lambda x: 2.0 * f(x), 1, [1])
    r, (J,) = outer.residuals_and_jacobians([torch.tensor([3.0], dtype=torch.float64)])
    np.testing.assert_allclose(r, [18.0])
    np.testing.assert_allclose(J, [[12.0]])


def test_data_argument():
    cost = AutoDiffCostFunction(lambda x, data: x - data, 2, [2])
    r = cost.residuals([torch.tensor([3.0, 4.0])], torch.tensor([1.0, 1.0]))
    np.testing.assert_allclose(r, [2.0, 3.0])


# ------------------------------------------------------- against the JAX package


@pytest.mark.parametrize("method", ["CENTRAL", "FORWARD", "RIDDERS"])
def test_numeric_diff_matches_jax(method):
    """Each method's residuals and Jacobians equal the JAX package's at the
    same point to 1e-9 relative (the same steps and extrapolation; the
    two packages round the perturbed residuals alike up to their math
    libraries)."""
    t = NumericDiffCostFunction(_functor, 2, [3, 2], method=method)
    j = ct.NumericDiffCostFunction(_jfunctor, 2, [3, 2], method=method)
    r1, j1 = t.residuals_and_jacobians(_t(PARAMS))
    r2, j2 = j.residuals_and_jacobians([jnp.asarray(p) for p in PARAMS])
    np.testing.assert_allclose(r1, np.asarray(r2), rtol=1e-15)
    for a, b in zip(j1, j2):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=1e-12)


def test_conditioned_cost_function_matches_jax():
    """r_i' = g_i(r_i) with an affine and a cubic conditioner, residuals
    and Jacobians to 1e-15 relative of the JAX package's."""
    def build(P, lib):
        wrapped = P.AutoDiffCostFunction(_functor if lib is torch else _jfunctor, 2, [3, 2])
        conds = [P.AutoDiffCostFunction(lambda r: 2.0 * r + 1.0, 1, [1]),
                 P.AutoDiffCostFunction(lambda r: r ** 3, 1, [1])]
        return P.ConditionedCostFunction(wrapped, conds)

    r1, j1 = build(ctt.cost_function, torch).residuals_and_jacobians(_t(PARAMS))
    r2, j2 = build(ct.cost_function, jnp).residuals_and_jacobians(
        [jnp.asarray(p) for p in PARAMS])
    np.testing.assert_allclose(r1, np.asarray(r2), rtol=1e-15)
    for a, b in zip(j1, j2):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-15)


def _curve(P, lib, method):
    """exp(m x + c) fitted to 20 points, the cost function of `method`
    over the one 2-parameter block, plus a NormalPrior on it."""
    rng = np.random.default_rng(7)
    xs = np.linspace(0.0, 1.0, 20)
    ys = np.exp(0.3 * xs + 0.1) + 0.01 * rng.standard_normal(20)
    mc = np.array([0.0, 0.0])

    def f(m, d):
        return (d[1] - lib.exp(m[0] * d[0] + m[1])).reshape(1)

    if method == "autodiff":
        cost = P.AutoDiffCostFunction(f, 1, [2])
    else:
        cost = P.NumericDiffCostFunction(f, 1, [2], method=method)
    p = P.Problem()
    for x, y in zip(xs, ys):
        p.add_residual_block(cost, None, [mc], data=np.array([x, y]))
    p.add_residual_block(P.NormalPrior(np.eye(2) * 0.1, np.array([0.2, 0.2])), None, [mc])
    return p, mc


@pytest.mark.parametrize("method", ["autodiff", "CENTRAL", "FORWARD", "RIDDERS"])
def test_cost_functions_batched_in_a_solve_match_jax(method):
    """Each cost function evaluated over its kind by vmap in a DENSE_QR
    solve: the same termination, rows and answer as the JAX fused loop,
    each row's cost to 1e-9 relative with autodiff. A finite difference
    over a step of ~1.5e-8 turns the two packages' last-bit differences
    in the residuals into ~eps/h = 1e-8 relative ones in the Jacobian, so
    the numeric rows agree to 1e-7."""
    jp, jmc = _curve(ct, jnp, method)
    tp, tmc = _curve(ctt, torch, method)
    ref = ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType.DENSE_QR,
                              fused_loop="ALWAYS"), jp)
    out = ctt.solve(ctt.Options(fused_loop="ALWAYS",
                                linear_solver_type=ctt.LinearSolverType.DENSE_QR), tp,
                    device="cpu")
    assert out.termination_type.name == ref.termination_type.name
    assert len(out.iterations) == len(ref.iterations)
    rel = 1e-9 if method == "autodiff" else 1e-7
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=rel)
    np.testing.assert_allclose(tmc, jmc, rtol=1e-7)
