"""The port's host trust-region loop (solvers/trust_region.py,
solvers/bsr_kernels.py) against the JAX package's TrustRegionMinimizer on
the CPU, row by row: fused_loop="NEVER" in both packages on a small BAL
problem with DENSE_QR, DENSE_NORMAL_CHOLESKY, DENSE_SCHUR, ITERATIVE_SCHUR
and CGNR in float64 and float32; box bounds (the projection of x0, the
active-set mask and the projected line search); non-monotonic steps; and
the repair of AUTO's choice of minimizer (both packages' AUTO takes the
host loop below 8,192 residuals). Each tolerance is stated where it is
used."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu.models import bal as jbal
from ceres_tpu.models import mgh as jmgh

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.models import mgh as tmgh
from ceres_tpu_torch.ops import kernels as kn
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SOLVERS = ["DENSE_QR", "DENSE_NORMAL_CHOLESKY", "DENSE_SCHUR", "ITERATIVE_SCHUR", "CGNR"]


def small_bal(seed=0, num_points=300):
    b = jbal.synthetic_bal(num_cameras=4, num_points=num_points, visibility=0.5, seed=seed)
    return jbal.perturb(b, 0.01, 0.05, 0.05, seed=1)


def tier_bal(lst):
    """The dense solvers factor the whole (N, tangent) Jacobian: 100 points
    keep their QR small; the block solvers take 300."""
    return small_bal(num_points=100 if lst.startswith("DENSE_") and "SCHUR" not in lst
                     else 300)


def _arrays(b):
    return (b.cameras.copy(), b.points.copy(), b.camera_index.copy(), b.point_index.copy(),
            b.observations.copy())


def jax_ba(b):
    return jbal.build_problem_batched(jbal.BALProblem(*_arrays(b)))


def port_ba(b):
    return tbal.build_problem_batched(tbal.from_arrays(*_arrays(b)))


def both(b, build=None, **kw):
    """(JAX summary, port summary, JAX points, port points) of one option
    set, solved in both packages from the same start."""
    out = []
    for pkg, make in [(ct, jax_ba), (ctt, port_ba)]:
        p, cams, pts = (build or make)(b) if build is None else build(pkg, b)
        opts = {k: (getattr(pkg, type(v).__name__)[v.name] if hasattr(v, "name") else v)
                for k, v in kw.items()}
        extra = {} if pkg is ct else {"device": "cpu"}
        out.append((pkg.solve(pkg.Options(**opts), p, **extra), pts))
    (ref, jpts), (s, tpts) = out
    return ref, s, np.array(jpts), np.array(tpts)


def assert_rows_match(s, ref, rel=1e-9, cg=True):
    """The same termination, message (up to its numbers, printed to 7
    digits) and rows: each row's cost to `rel`, its radius to 1e-6
    relative (the radius update reads the step quality, the cost change
    over the model's: a change of 1e-4 of the cost loses four digits to
    cancellation), its validity, and the same CG counts."""
    assert s.termination_type.name == ref.termination_type.name
    assert s.message.split(":")[0] == ref.message.split(":")[0]
    assert len(s.iterations) == len(ref.iterations)
    for a, c in zip(ref.iterations, s.iterations):
        assert c.cost == pytest.approx(a.cost, rel=rel, abs=1e-300)
        assert c.trust_region_radius == pytest.approx(a.trust_region_radius, rel=1e-6)
        assert c.step_is_successful == a.step_is_successful
        if cg:
            assert c.linear_solver_iterations == a.linear_solver_iterations
    assert s.num_successful_steps == ref.num_successful_steps
    assert s.num_unsuccessful_steps == ref.num_unsuccessful_steps


@pytest.mark.parametrize("lst", SOLVERS)
def test_host_loop_float64_matches_jax_row_for_row(lst):
    """float64: each row's cost and radius within 1e-9 relative, the same
    CG counts, termination and message, the final state within 1e-8
    relative (1e-10 absolute)."""
    b = tier_bal(lst)
    kn.reset_counts()
    ref, s, jpts, tpts = both(b, linear_solver_type=ctt.LinearSolverType[lst],
                              fused_loop="NEVER")
    assert_rows_match(s, ref)
    assert s.final_cost == pytest.approx(ref.final_cost, rel=1e-9)
    np.testing.assert_allclose(tpts, jpts, rtol=1e-8, atol=1e-10)
    assert s.num_jacobian_evaluations == ref.num_jacobian_evaluations
    assert s.num_linear_solves == ref.num_linear_solves
    assert s.num_host_syncs > 0
    # the flat products of the block solvers ran kernels 6, 7 and 9 (their
    # plain versions here, on the CPU); the dense solvers none
    if lst in ("DENSE_SCHUR", "ITERATIVE_SCHUR", "CGNR"):
        assert kn.segment_block_expand.plain_calls > 0
        assert kn.segment_block_sum.plain_calls > 0
        assert kn.unsorted_segment_sum.plain_calls > 0
    else:
        assert all(k.plain_calls == 0 for k in kn.KERNELS)
    if lst == "CGNR":
        assert kn.normal_matvec.plain_calls > 0


@pytest.mark.parametrize("lst", SOLVERS)
def test_host_loop_float32_final_cost_matches_jax(lst):
    """float32: the final cost within 1e-5 relative of the JAX package's
    (whose float32 cost is summed in float32; the port's in float64), both
    converged."""
    ref, s, _, _ = both(tier_bal(lst), linear_solver_type=ctt.LinearSolverType[lst],
                        fused_loop="NEVER", evaluation_dtype="float32")
    assert s.termination_type.name == ref.termination_type.name == "CONVERGENCE"
    assert s.final_cost == pytest.approx(ref.final_cost, rel=1e-5)


def _bounded(pkg, b):
    p, cams, pts = (jax_ba if pkg is ct else port_ba)(b)
    lo = np.percentile(b.points, 2.0, axis=0)
    hi = np.percentile(b.points, 98.0, axis=0)
    p.set_parameter_block_array_bounds(p.parameter_block_arrays()[1], lower=lo, upper=hi)
    return p, cams, pts


@pytest.mark.parametrize("lst,rel", [("DENSE_SCHUR", 1e-9), ("ITERATIVE_SCHUR", 1e-7)])
def test_bounded_host_loop_matches_jax_row_for_row(lst, rel):
    """A box on the points that clips part of the start: x0 projected, the
    active-set mask, the projected Armijo search. Each row's cost within
    `rel`, the same CG counts, the final points inside the box and within
    100 `rel` (1e-10 absolute) of the JAX package's. ITERATIVE_SCHUR's
    rows drift from the JAX package's by up to 9e-9 here (its 8-25 CG
    iterations a row, stopped by eta = 0.1 on this start far from the
    minimum, carry the products' rounding into each step): 1e-7."""
    b = jbal.perturb(jbal.synthetic_bal(num_cameras=5, num_points=80, visibility=0.5,
                                        seed=3), 0.01, 0.05, 0.2)
    ref, s, jpts, tpts = both(b, build=_bounded, linear_solver_type=ctt.LinearSolverType[lst],
                              fused_loop="NEVER")
    assert s.is_constrained
    assert_rows_match(s, ref, rel=rel)
    np.testing.assert_allclose(tpts, jpts, rtol=100 * rel, atol=1e-10)
    lo, hi = np.percentile(b.points, 2.0, axis=0), np.percentile(b.points, 98.0, axis=0)
    assert np.all(tpts >= lo - 1e-12) and np.all(tpts <= hi + 1e-12)


@pytest.mark.parametrize("number", [7, 11, 18])
def test_nonmonotonic_host_loop_matches_jax_row_for_row(number):
    """use_nonmonotonic_steps on the MGH problems whose host loop accepts
    steps that raise the cost (#7 once, #11 twice, #18 once), with the
    solver's default tolerances: each row's cost within 1e-9 relative or
    1e-20 absolute, the same rows, validity and non-monotonic flags."""
    kw = dict(function_tolerance=1e-6, parameter_tolerance=1e-8, gradient_tolerance=1e-10,
              use_nonmonotonic_steps=True, max_consecutive_nonmonotonic_steps=3)
    _, _, ref = jmgh.solve_problem(jmgh.PROBLEMS[number - 1], options_overrides=dict(kw))
    _, _, s = tmgh.solve_problem(tmgh.PROBLEMS[number - 1], options_overrides=dict(kw),
                                 device="cpu")
    assert s.termination_type.name == ref.termination_type.name
    assert len(s.iterations) == len(ref.iterations)
    for a, c in zip(ref.iterations, s.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9, abs=1e-20)
        assert (c.step_is_successful, c.step_is_nonmonotonic) == (
            a.step_is_successful, a.step_is_nonmonotonic)
    assert any(r.step_is_nonmonotonic for r in s.iterations[1:])


# -- AUTO's choice: both packages take the host loop below 8,192 residuals

def _powell(pkg):
    xs = [np.asarray([3.0]), np.asarray([-1.0]), np.asarray([0.0]), np.asarray([1.0])]
    p = pkg.Problem()
    terms = [(lambda a, b: a[0] + 10 * b[0], 0, 1),
             (lambda a, b: math.sqrt(5.0) * (a[0] - b[0]), 2, 3),
             (lambda a, b: (a[0] - 2 * b[0]) ** 2, 1, 2),
             (lambda a, b: math.sqrt(10.0) * (a[0] - b[0]) ** 2, 0, 3)]
    for f, i, j in terms:
        p.add_residual_block(pkg.AutoDiffCostFunction(f, 1, [1, 1]), None, [xs[i], xs[j]])
    return p, xs


def _curve_fit(pkg, exp):
    rng = np.random.default_rng(0)
    xs = np.linspace(0, 5, 67)
    ys = np.exp(0.3 * xs + 0.1) + 0.2 * rng.standard_normal(67)
    cost = pkg.AutoDiffCostFunction(lambda mc, d: d[1] - exp(mc[0] * d[0] + mc[1]), 1, [2])
    mc = np.zeros(2)
    p = pkg.Problem()
    for x, y in zip(xs, ys):
        p.add_residual_block(cost, None, [mc], data=(np.float64(x), np.float64(y)))
    return p, [mc]


@pytest.mark.parametrize("case,lst", [("powell", "DENSE_QR"),
                                      ("powell", "DENSE_NORMAL_CHOLESKY"),
                                      ("curve_fit", "DENSE_QR")])
def test_auto_picks_the_same_minimizer_as_jax(case, lst):
    """Powell's function and the curve fit of tests/test_solver.py with the
    default options but the linear solver (the JAX default,
    SPARSE_NORMAL_CHOLESKY, is a later slice of the port): AUTO takes the
    host loop in both packages, so the same rows, each row's cost within
    1e-10 relative (1e-30 absolute: Powell's cost falls to 0), and the same
    answer (1e-8)."""
    runs = []
    for pkg, fn in [(ct, jnp), (ctt, torch)]:
        p, xs = _powell(pkg) if case == "powell" else _curve_fit(pkg, fn.exp)
        extra = {} if pkg is ct else {"device": "cpu"}
        opts = pkg.Options(linear_solver_type=pkg.LinearSolverType[lst], max_num_iterations=100)
        runs.append((pkg.solve(opts, p, **extra), np.concatenate(xs)))
    (ref, jx), (s, tx) = runs
    assert s.termination_type.name == ref.termination_type.name == "CONVERGENCE"
    assert len(s.iterations) == len(ref.iterations)
    for a, c in zip(ref.iterations, s.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-10, abs=1e-30)
    np.testing.assert_allclose(tx, jx, rtol=1e-8, atol=1e-8)
    # the fused loop's summary counts one host sync per row; the host loop
    # about three: the count says which loop ran
    assert s.num_host_syncs > 2 * len(s.iterations)


def test_build_fused_minimizer_returns_none_where_jax_does():
    """DOGLEG on an iterative tier: no fused minimizer (the JAX factory's
    None), so the caller takes the host loop."""
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solvers.fused_lm import build_fused_minimizer

    p = port_ba(small_bal())[0]
    prog = CompiledProgram(p, device="cpu")
    opts = ctt.Options(trust_region_strategy_type=ctt.TrustRegionStrategyType.DOGLEG)
    assert build_fused_minimizer(prog, opts, "schur_iterative", e_families=[1]) is None
    assert build_fused_minimizer(prog, opts, "bsr") is None
    assert build_fused_minimizer(prog, opts, "schur_dense", e_families=[1]) is not None
