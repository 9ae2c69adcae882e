"""The port's Options, its gradient checker (ceres_tpu_torch/gradient_checker.py)
and the check_gradients path of solve() against the JAX package's, on the
CPU: every JAX Options field with the JAX default, a wrong Jacobian that
ends both solves with the JAX message, a right one that passes and
solves, the tangent-space probe on a manifold, the thread counts of the
summary, and the validation and slice errors of the line-search fields.
Each tolerance is stated where it is used."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct

import ceres_tpu_torch as ctt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_options_have_every_jax_field_with_its_default():
    """Every field of the JAX Options is one of the port's with the same
    default, but the dump directory (the port's default is the temporary
    directory, on purpose)."""
    jax_fields = {f.name: f for f in dataclasses.fields(ct.Options)}
    port_fields = {f.name: f for f in dataclasses.fields(ctt.Options)}
    assert set(jax_fields) <= set(port_fields)
    jo, po = ct.Options(), ctt.Options()
    for name in jax_fields:
        if name == "trust_region_problem_dump_directory":
            continue
        jv, pv = getattr(jo, name), getattr(po, name)
        if hasattr(jv, "name") and hasattr(pv, "name"):  # enums of either package
            assert (type(jv).__name__, jv.name) == (type(pv).__name__, pv.name), name
        else:
            assert jv == pv, name


def _square_problem(pkg, jacobian_factor):
    """r = x^2 - 2 from x = 3 with the Jacobian jacobian_factor * x: 2 is
    right, 3 is wrong."""
    xp = jnp if pkg is ct else torch

    class Square(pkg.AnalyticCostFunction):
        num_residuals = 1
        parameter_block_sizes = (1,)

        def residuals(self, params, data=None):
            return params[0] ** 2 - 2.0

        def jacobians(self, params, data=None):
            return [xp.reshape(jacobian_factor * params[0], (1, 1))]

    x = np.array([3.0])
    p = pkg.Problem()
    p.add_residual_block(Square(), None, [x])
    return p, x


def _solve(pkg, problem, **kw):
    opts = pkg.Options(check_gradients=True,
                       linear_solver_type=pkg.LinearSolverType.DENSE_QR, **kw)
    if pkg is ctt:
        return ctt.solve(opts, problem, device="cpu")
    return ct.solve(opts, problem)


def test_wrong_jacobian_fails_with_the_jax_message():
    """Both packages end in FAILURE before the first iteration, with the
    same message ("Gradient Error detected!" and the block's error), and
    leave x where it was."""
    jp, jx = _square_problem(ct, 3.0)
    tp, tx = _square_problem(ctt, 3.0)
    js, ts = _solve(ct, jp), _solve(ctt, tp)
    assert js.termination_type.name == ts.termination_type.name == "FAILURE"
    assert ts.message.startswith("Gradient Error detected!")
    assert ts.message == js.message
    assert ts.iterations == [] and tx[0] == jx[0] == 3.0


def test_right_jacobian_passes_and_solves():
    """The right Jacobian passes the check; both solves converge to
    sqrt(2), within 1e-12 of each other."""
    jp, jx = _square_problem(ct, 2.0)
    tp, tx = _square_problem(ctt, 2.0)
    js, ts = _solve(ct, jp), _solve(ctt, tp)
    assert js.termination_type.name == ts.termination_type.name == "CONVERGENCE"
    assert len(ts.iterations) == len(js.iterations)
    assert abs(tx[0] - jx[0]) <= 1e-12 and abs(tx[0] - np.sqrt(2.0)) <= 1e-8


def _probe(pkg, scale):
    """A 3-vector on the unit sphere, r = A x + |x|^2 a, with its Jacobian
    times `scale` (1 is right)."""
    xp = jnp if pkg is ct else torch
    a = np.array([0.3, -0.7, 1.1])
    A = np.array([[1.0, 0.2, 0.3], [0.4, 1.0, -0.5], [0.1, 0.7, 1.0]])

    class Cost(pkg.AnalyticCostFunction):
        num_residuals = 3
        parameter_block_sizes = (3,)

        def residuals(self, params, data=None):
            x = params[0]
            return xp.asarray(A) @ x + xp.sum(x * x) * xp.asarray(a)

        def jacobians(self, params, data=None):
            x = params[0]
            J = xp.asarray(A) + 2.0 * xp.asarray(a)[:, None] * x[None, :]
            return [scale * J]

    x = np.array([0.48, 0.6, 0.64])  # on the unit sphere
    checker = pkg.GradientChecker(Cost(), [pkg.SphereManifold(3)], relative_step_size=1e-6)
    return checker.probe([x], 1e-6)


@pytest.mark.parametrize("scale", [1.0, 1.01])
def test_probe_on_a_manifold_matches_jax(scale):
    """GradientChecker.probe in the sphere's tangent space: the same
    verdict, the local Jacobians within 1e-12, and the maximum relative
    error within 1e-8 of the JAX probe's."""
    jr, tr = _probe(ct, scale), _probe(ctt, scale)
    assert jr.return_value == tr.return_value == (scale == 1.0)
    assert tr.local_jacobians[0].shape == (3, 2)
    np.testing.assert_allclose(tr.local_jacobians[0], jr.local_jacobians[0], atol=1e-12)
    assert abs(tr.maximum_relative_error - jr.maximum_relative_error) <= 1e-8
    assert (tr.error_log == "") == (jr.error_log == "")


def test_summary_thread_counts_match_jax():
    """num_threads_given is the option, num_threads_used 1, in both."""
    for n in (1, 4):
        jp, _ = _square_problem(ct, 2.0)
        tp, _ = _square_problem(ctt, 2.0)
        js = ct.solve(ct.Options(num_threads=n), jp)
        ts = ctt.solve(ctt.Options(num_threads=n), tp, device="cpu")
        assert (ts.num_threads_given, ts.num_threads_used) == (
            js.num_threads_given, js.num_threads_used) == (n, 1)


def test_line_search_validation_matches_jax():
    """LINE_SEARCH with LBFGS and ARMIJO fails both packages' validation
    with one message; a valid line-search request (LBFGS and WOLFE, the
    defaults) solves in the port as in the JAX package: the same final
    cost within 1e-12 relative."""
    kw = dict(minimizer_type="LINE_SEARCH", line_search_type="ARMIJO")
    jo = ct.Options(minimizer_type=ct.MinimizerType.LINE_SEARCH,
                    line_search_type=ct.LineSearchType.ARMIJO)
    to = ctt.Options(minimizer_type=ctt.MinimizerType.parse(kw["minimizer_type"]),
                     line_search_type=ctt.LineSearchType.parse(kw["line_search_type"]))
    assert jo.is_valid() == to.is_valid()
    assert to.is_valid()[0] is False
    tp, _ = _square_problem(ctt, 2.0)
    s = ctt.solve(to, tp, device="cpu")
    assert s.termination_type == ctt.TerminationType.FAILURE
    assert s.message == jo.is_valid()[1]
    jp, jx = _square_problem(ct, 2.0)
    tp, tx = _square_problem(ctt, 2.0)
    js = ct.solve(ct.Options(minimizer_type=ct.MinimizerType.LINE_SEARCH), jp)
    ts = ctt.solve(ctt.Options(minimizer_type=ctt.MinimizerType.LINE_SEARCH), tp, device="cpu")
    assert ts.termination_type.name == js.termination_type.name
    assert ts.is_solution_usable()
    assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-12, abs=1e-20)
    assert tx[0] == pytest.approx(jx[0], rel=1e-12)
