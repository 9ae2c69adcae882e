"""The port's GradientProblem and solve_gradient_problem against the JAX
package's on the CPU: the quaternion-manifold fit of
tests/test_satellite_apis.py:185-207, a user-given gradient, and the
adapter program cached on the problem. Each tolerance is stated where it
is used."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu import rotation as jrot
from ceres_tpu.gradient_problem import GradientProblem as JaxGradientProblem
from ceres_tpu.gradient_problem import solve_gradient_problem as jax_solve_gp

import ceres_tpu_torch as ctt
from ceres_tpu_torch import rotation as trot
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _ls(pkg, **kw):
    return pkg.Options(minimizer_type=pkg.MinimizerType.LINE_SEARCH, **kw)


def test_gradient_problem_with_manifold():
    """Rotate the x axis onto the z axis by a unit quaternion under the
    QuaternionManifold (AUTO: the host loop in both): cost below 1e-12,
    the quaternion unit within 1e-9 and equal to the JAX one within 1e-12,
    every row within 1e-12 relative."""
    def cost_j(q):
        v = jrot.unit_quaternion_rotate_point(q, jnp.asarray([1.0, 0.0, 0.0]))
        return jnp.sum((v - jnp.asarray([0.0, 0.0, 1.0])) ** 2)

    def cost_t(q):
        v = trot.unit_quaternion_rotate_point(
            q, torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64))
        return torch.sum((v - torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)) ** 2)

    qj, qt = np.asarray([1.0, 0.0, 0.0, 0.0]), np.asarray([1.0, 0.0, 0.0, 0.0])
    sj = jax_solve_gp(_ls(ct, max_num_iterations=200),
                      JaxGradientProblem(cost_j, 4, manifold=ct.QuaternionManifold()), qj)
    st = ctt.solve_gradient_problem(
        _ls(ctt, max_num_iterations=200),
        ctt.GradientProblem(cost_t, 4, manifold=ctt.QuaternionManifold()), qt, device="cpu")
    assert st.final_cost < 1e-12
    np.testing.assert_allclose(np.linalg.norm(qt), 1.0, atol=1e-9)
    np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-12)
    np.testing.assert_allclose([r.cost for r in st.iterations],
                               [r.cost for r in sj.iterations], rtol=1e-12, atol=1e-20)
    assert st.minimizer_type == ctt.MinimizerType.LINE_SEARCH
    assert st.num_effective_parameters == 3 and st.num_parameters == 4


def _rosen(x):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] * x[0]) ** 2


def _rosen_grad(xp):
    def grad(x):
        return xp.stack([-2.0 * (1.0 - x[0]) - 400.0 * x[0] * (x[1] - x[0] * x[0]),
                         200.0 * (x[1] - x[0] * x[0])])
    return grad


@pytest.mark.parametrize("fused", ["NEVER", "ALWAYS"])
def test_user_gradient_matches_jax(fused):
    """Rosenbrock with the user's analytic gradient (the
    FirstOrderFunction::Evaluate analog) in each loop against the JAX loop
    of its kind: LBFGS + WOLFE to [1, 1], the answer within 1e-9 of the
    JAX one, the first 20 rows within 1e-6 relative, and within 1e-9 of
    the port's own autograd solve's answer."""
    o = dict(fused_loop=fused, max_num_iterations=300)
    xj, xt, xa = (np.asarray([-1.2, 1.0]) for _ in range(3))
    sj = jax_solve_gp(_ls(ct, **o), JaxGradientProblem(_rosen, 2, gradient=_rosen_grad(jnp)),
                      xj)
    st = ctt.solve_gradient_problem(
        _ls(ctt, **o), ctt.GradientProblem(_rosen, 2, gradient=_rosen_grad(torch)), xt,
        device="cpu")
    ctt.solve_gradient_problem(_ls(ctt, **o), ctt.GradientProblem(_rosen, 2), xa,
                               device="cpu")
    assert st.termination_type.name == sj.termination_type.name == "CONVERGENCE"
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(xt, [1.0, 1.0], atol=1e-9)
    np.testing.assert_allclose(xt, xa, rtol=0, atol=1e-9)
    np.testing.assert_allclose([r.cost for r in st.iterations][:20],
                               [r.cost for r in sj.iterations][:20], rtol=1e-6, atol=1e-14)


def test_repeated_solve_reuses_the_adapter_and_its_fused_minimizer():
    """A second solve of one GradientProblem reuses its adapter program and
    the fused minimizer cached on it, and repeats the first solve's rows
    bit for bit from the same start."""
    gp = ctt.GradientProblem(_rosen, 2)
    o = _ls(ctt, fused_loop="ALWAYS", max_num_iterations=100)
    x1 = np.asarray([-1.2, 1.0])
    s1 = ctt.solve_gradient_problem(o, gp, x1, device="cpu")
    prog = gp._cached_programs["cpu"]
    (m1,) = prog._minimizer_cache.values()
    x2 = np.asarray([-1.2, 1.0])
    s2 = ctt.solve_gradient_problem(o, gp, x2, device="cpu")
    assert gp._cached_programs["cpu"] is prog
    (m2,) = prog._minimizer_cache.values()
    assert m2 is m1
    assert [r.cost for r in s2.iterations] == [r.cost for r in s1.iterations]
    np.testing.assert_array_equal(x2, x1)
