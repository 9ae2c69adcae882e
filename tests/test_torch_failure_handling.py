"""Numerical failure handling in the port against the JAX package on the
CPU, the twins of tests/test_failure_handling.py: a NaN residual at the
start, NaN candidates, the solve-time limit, a zero Jacobian, a
rank-deficient DENSE_NORMAL_CHOLESKY, and the summary's step counts.
Each test solves the same problem in both packages (default options: the
host loop over SPARSE_NORMAL_CHOLESKY at these sizes) and compares the
termination, the message, the iterate and the step counts."""
import jax.numpy as jnp
import numpy as np
import torch

import ceres_tpu as ct

import ceres_tpu_torch as ctt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _one_block(pkg, fn, x0, size=1):
    x = np.asarray(x0, np.float64)
    p = pkg.Problem()
    p.add_residual_block(pkg.AutoDiffCostFunction(fn, 1, [size]), None, [x])
    return p, x


def _solve(pkg, opts_kw, problem):
    opts = pkg.Options(**opts_kw)
    if pkg is ctt:
        return ctt.solve(opts, problem, device="cpu")
    return ct.solve(opts, problem)


def _both(fns, x0, size=1, **opts_kw):
    """(JAX summary, JAX x, port summary, port x) of one problem."""
    jp, jx = _one_block(ct, fns[0], x0, size)
    tp, tx = _one_block(ctt, fns[1], x0, size)
    return _solve(ct, opts_kw, jp), jx, _solve(ctt, opts_kw, tp), tx


def _same(js, ts, jx, tx, tol=1e-12, message=lambda m: m):
    """The same termination, message (as `message` reads it), step counts
    and rows, the iterate within tol."""
    assert ts.termination_type.name == js.termination_type.name
    assert message(ts.message) == message(js.message)
    assert (ts.num_successful_steps, ts.num_unsuccessful_steps) == (
        js.num_successful_steps, js.num_unsuccessful_steps)
    assert len(ts.iterations) == len(js.iterations)
    np.testing.assert_allclose(tx, jx, rtol=tol, atol=tol)


def test_nan_residual_at_start_fails_cleanly():
    """sqrt(x - 10) at x = 1: the first evaluation fails in both."""
    js, jx, ts, tx = _both((lambda v: jnp.sqrt(v[0] - 10.0), lambda v: torch.sqrt(v[0] - 10.0)),
                           [1.0], max_num_iterations=10)
    assert ts.termination_type == ctt.TerminationType.FAILURE
    assert "failed" in ts.message.lower()
    _same(js, ts, jx, tx)


def test_candidate_nan_treated_as_infinite_cost():
    """log(x) - 1 from x = 4: a long step lands at x <= 0 (NaN); both
    reject it and converge to e."""
    js, jx, ts, tx = _both((lambda v: jnp.log(v[0]) - 1.0, lambda v: torch.log(v[0]) - 1.0),
                           [4.0], max_num_iterations=100)
    assert ts.termination_type == ctt.TerminationType.CONVERGENCE
    _same(js, ts, jx, tx, tol=1e-10)
    np.testing.assert_allclose(tx[0], np.e, rtol=1e-5)


def _powell(pkg):
    """Powell's function in four one-parameter blocks (tests/test_solver.py)."""
    xp = jnp if pkg is ct else torch
    xs = [np.asarray([v]) for v in (3.0, -1.0, 0.0, 1.0)]
    p = pkg.Problem()
    terms = [(lambda a, b: a[0] + 10 * b[0], 0, 1),
             (lambda a, b: np.sqrt(5.0) * (a[0] - b[0]), 2, 3),
             (lambda a, b: (a[0] - 2 * b[0]) ** 2, 1, 2),
             (lambda a, b: np.sqrt(10.0) * (a[0] - b[0]) ** 2, 0, 3)]
    for fn, i, j in terms:
        p.add_residual_block(pkg.AutoDiffCostFunction(
            lambda a, b, fn=fn: xp.atleast_1d(fn(a, b)), 1, [1, 1]), None, [xs[i], xs[j]])
    return p, xs


def test_max_solver_time_termination():
    """A time limit of 0 s ends both solves with NO_CONVERGENCE, its
    message naming the time (the text before the elapsed seconds, which
    differ), before any step."""
    jp, jxs = _powell(ct)
    tp, txs = _powell(ctt)
    kw = dict(max_num_iterations=100000, max_solver_time_in_seconds=0.0)
    js, ts = _solve(ct, kw, jp), _solve(ctt, kw, tp)
    assert ts.termination_type == ctt.TerminationType.NO_CONVERGENCE
    assert "time" in ts.message.lower()
    _same(js, ts, np.concatenate(jxs), np.concatenate(txs),
          message=lambda m: m.split(":")[0])


def test_min_trust_region_radius_termination():
    """A zero Jacobian with a nonzero residual: the gradient is zero, so
    both converge at once on the gradient tolerance."""
    js, jx, ts, tx = _both((lambda v: v * 0.0 + 3.0, lambda v: v * 0.0 + 3.0), [1.0],
                           max_num_iterations=500)
    assert ts.termination_type == ctt.TerminationType.CONVERGENCE
    _same(js, ts, jx, tx)


def test_linear_solver_failure_retries_then_fails():
    """A rank-deficient Jacobian under DENSE_NORMAL_CHOLESKY: the LM
    damping keeps the normal equations solvable, and both reach
    x0 + x1 = 2 at the same iterate."""
    fns = (lambda v: jnp.atleast_1d(v[0] + v[1] - 2.0),
           lambda v: torch.atleast_1d(v[0] + v[1] - 2.0))
    jp, jx = _one_block(ct, fns[0], [1.0, 1.0], 2)
    tp, tx = _one_block(ctt, fns[1], [1.0, 1.0], 2)
    js = ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType.DENSE_NORMAL_CHOLESKY,
                             max_num_iterations=50), jp)
    ts = ctt.solve(ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_NORMAL_CHOLESKY,
                               max_num_iterations=50), tp, device="cpu")
    assert ts.is_solution_usable()
    assert abs(float(tx[0] + tx[1]) - 2.0) < 1e-8
    _same(js, ts, jx, tx)


def test_summary_counts_consistent():
    """Powell's function: rows = successful + unsuccessful steps, a
    nonnegative cumulative time, and the JAX package's rows and iterate
    (1e-10)."""
    jp, jxs = _powell(ct)
    tp, txs = _powell(ctt)
    js, ts = _solve(ct, dict(max_num_iterations=100), jp), _solve(
        ctt, dict(max_num_iterations=100), tp)
    assert ts.num_successful_steps >= 1
    assert len(ts.iterations) == ts.num_successful_steps + ts.num_unsuccessful_steps
    assert ts.iterations[-1].cumulative_time_in_seconds >= 0
    _same(js, ts, np.concatenate(jxs), np.concatenate(txs), tol=1e-10)
