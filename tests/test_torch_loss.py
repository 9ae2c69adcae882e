"""ceres_tpu_torch.loss against ceres_tpu.loss (the twin of
tests/test_loss.py): rho, rho' and rho'' of the nine losses and the
wrapper on a grid from s = 0 to the outlier side, the corrector, and the
loss chain that the eval_fused kernel takes. Inputs from numpy; 1e-14 in
float64, 1e-6 in float32, relative to each output's largest entry."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu import loss as jloss

import ceres_tpu_torch as ctt
from ceres_tpu_torch import loss as tloss


def _pair(name):
    """(JAX loss, port loss) of one case."""
    def both(cls, *args):
        return getattr(ct, cls)(*args), getattr(ctt, cls)(*args)

    if name == "Composed":
        return (ct.ComposedLoss(ct.HuberLoss(1.1), ct.SoftLOneLoss(0.5)),
                ctt.ComposedLoss(ctt.HuberLoss(1.1), ctt.SoftLOneLoss(0.5)))
    if name == "Scaled":
        return (ct.ScaledLoss(ct.CauchyLoss(1.0), 3.0),
                ctt.ScaledLoss(ctt.CauchyLoss(1.0), 3.0))
    if name == "ScaledNone":
        return ct.ScaledLoss(None, 0.5), ctt.ScaledLoss(None, 0.5)
    if name == "Wrapper":
        return (ct.LossFunctionWrapper(ct.TukeyLoss(1.5)),
                ctt.LossFunctionWrapper(ctt.TukeyLoss(1.5)))
    if name == "WrapperNone":
        return ct.LossFunctionWrapper(None), ctt.LossFunctionWrapper(None)
    args = {"Trivial": (), "Huber": (0.7,), "SoftLOne": (0.7,), "Cauchy": (1.3,),
            "Arctan": (1.3,), "Tolerant": (0.7, 0.4), "Tukey": (2.0,)}[name]
    return both(name + "Loss", *args)


NAMES = ["Trivial", "Huber", "SoftLOne", "Cauchy", "Arctan", "Tolerant", "Tukey",
         "Composed", "Scaled", "ScaledNone", "Wrapper", "WrapperNone"]
# s = 0, the inlier side, each loss's kink, the outlier side and Tolerant's
# large-x branch (x = (s - a) / b > 36)
GRID = np.array([0.0, 1e-3, 0.1, 0.3, 0.49, 0.5, 1.0, 1.69, 2.0, 3.9, 4.0, 4.1,
                 7.5, 25.0, 400.0])
TOL = {"float64": 1e-14, "float32": 1e-6}


def _close(out, ref, tol):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    assert out.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(out - ref).max() <= tol * scale, (np.abs(out - ref).max(), scale)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", NAMES)
def test_loss_matches_jax(name, dtype):
    jl, tl = _pair(name)
    ref = jl.evaluate(jnp.asarray(GRID, dtype))
    out = tl.evaluate(torch.as_tensor(GRID, dtype=getattr(torch, dtype)))
    for o, r in zip(out, ref):
        assert o.dtype == getattr(torch, dtype)
        _close(o.numpy(), r, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", NAMES)
def test_loss_chain_matches_jax(name, dtype):
    """The chain the kernel takes (flatten_loss, evaluate_chain) computes
    what the JAX loss computes."""
    jl, tl = _pair(name)
    chain = tloss.flatten_loss(tl)
    assert chain is not None and len(chain.ops) <= tloss.MAX_CHAIN
    ref = jl.evaluate(jnp.asarray(GRID, dtype))
    out = tloss.evaluate_chain(chain, torch.as_tensor(GRID, dtype=getattr(torch, dtype)))
    for o, r in zip(out, ref):
        _close(o.numpy(), r, TOL[dtype])


def test_flatten_loss_refuses_what_the_kernel_does_not_take():
    class Mine(ctt.LossFunction):
        def evaluate(self, s):
            return s, torch.ones_like(s), torch.zeros_like(s)

    assert tloss.flatten_loss(None) == tloss.LossChain()
    assert tloss.flatten_loss(ctt.TrivialLoss()) == tloss.LossChain()
    assert tloss.flatten_loss(Mine()) is None
    assert tloss.flatten_loss(ctt.ComposedLoss(Mine(), ctt.HuberLoss(1.0))) is None
    deep = ctt.HuberLoss(1.0)
    for _ in range(4):
        deep = ctt.ScaledLoss(deep, 2.0)
    assert tloss.flatten_loss(deep) is None  # five ops
    chain = tloss.flatten_loss(ctt.ScaledLoss(ctt.ComposedLoss(
        ctt.CauchyLoss(0.5), ctt.TolerantLoss(1.0, 0.2)), 2.0))
    assert [op.code for op in chain.ops] == [tloss.TOLERANT, tloss.CAUCHY, tloss.SCALE]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["Trivial", "Huber", "Cauchy", "Tukey", "Composed"])
def test_corrector_matches_jax(name, dtype):
    """correct_residuals_and_jacobians: costs, residuals and Jacobians,
    residual norms from 0 to far outliers (Tukey's rho' = 0 there)."""
    rng = np.random.default_rng(42)
    B, m, n = 40, 2, 5
    res = rng.standard_normal((B, m)) * np.linspace(0.0, 6.0, B)[:, None]
    J = [rng.standard_normal((B, m, n)), rng.standard_normal((B, m, 3))]
    jl, tl = _pair(name)
    ref = jloss.correct_residuals_and_jacobians(
        jl, jnp.asarray(res, dtype), [jnp.asarray(j, dtype) for j in J])
    tdt = getattr(torch, dtype)
    out = tloss.correct_residuals_and_jacobians(
        tl, torch.as_tensor(res, dtype=tdt), [torch.as_tensor(j, dtype=tdt) for j in J])
    _close(out[0].numpy(), ref[0], TOL[dtype])
    _close(out[1].numpy(), ref[1], TOL[dtype])
    for o, r in zip(out[2], ref[2]):
        _close(o.numpy(), r, TOL[dtype])


def test_corrector_gives_the_robust_gradient():
    """J_c' r_c == rho' J' r, the corrector's defining property."""
    rng = np.random.default_rng(3)
    res = torch.as_tensor(rng.standard_normal((5, 3)))
    J = torch.as_tensor(rng.standard_normal((5, 3, 4)))
    loss = ctt.CauchyLoss(0.8)
    cost_b, res_c, (J_c,) = tloss.correct_residuals_and_jacobians(loss, res, [J])
    rho0, rho1, _ = loss.evaluate(torch.sum(res * res, dim=1))
    torch.testing.assert_close(cost_b, 0.5 * rho0, rtol=1e-15, atol=0)
    torch.testing.assert_close(torch.einsum("brn,br->bn", J_c, res_c),
                               rho1[:, None] * torch.einsum("brn,br->bn", J, res),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("s", [0.1, 0.5, 1.0, 2.0, 5.0])
def test_derivative_consistency(name, s):
    """rho' and rho'' against central differences (loss_function_test.cc)."""
    loss = _pair(name)[1]
    eps = 1e-6
    at = torch.tensor([s - eps, s, s + eps], dtype=torch.float64)
    r0, r1, r2 = loss.evaluate(at)
    np.testing.assert_allclose(r1[1], (r0[2] - r0[0]) / (2 * eps), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(r2[1], (r1[2] - r1[0]) / (2 * eps), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_zero_and_monotone(name):
    loss = _pair(name)[1]
    assert abs(float(loss.evaluate(torch.zeros((), dtype=torch.float64))[0])) < 1e-12
    r = loss.evaluate(torch.linspace(0.0, 10.0, 101, dtype=torch.float64))[0]
    assert bool(torch.all(torch.diff(r) >= -1e-12))
