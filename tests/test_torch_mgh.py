"""The More-Garbow-Hillstrom corpus through ceres_tpu_torch.models.mgh on
the CPU, against ceres_tpu.models.mgh: problems 1-19 at trial 0 with
DENSE_QR and the corpus's options, in the fused loop (fused_loop="ALWAYS"
in both packages) and in the host loop that both packages' AUTO picks for
problems this small (default options in both); the same successes (17:
all but #2, which stops at the local minimum 48.98425367924, and #16, the
slow LM crawl of Brown-Dennis), and DENSE_NORMAL_CHOLESKY's. Each
tolerance is stated where it is used."""
import dataclasses

import numpy as np
import pytest

from ceres_tpu.models import mgh as jmgh

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import mgh as tmgh
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MISSES = {2, 16}
NUMBERS = [p.number for p in tmgh.PROBLEMS]


_FUSED = {"fused_loop": "ALWAYS"}


@pytest.fixture(scope="module")
def suites():
    port = {p.number: tmgh.solve_problem(p, options_overrides=_FUSED, device="cpu")
            for p in tmgh.PROBLEMS}
    jax = {p.number: jmgh.solve_problem(p, options_overrides=_FUSED)
           for p in jmgh.PROBLEMS}
    return port, jax


@pytest.fixture(scope="module")
def host_suites():
    """Default options in both packages: AUTO takes the host loop."""
    port = {p.number: tmgh.solve_problem(p, device="cpu") for p in tmgh.PROBLEMS}
    jax = {p.number: jmgh.solve_problem(p) for p in jmgh.PROBLEMS}
    return port, jax


def test_the_corpus_is_the_jax_packages():
    """The same 19 problems: names, sizes, starts, bounds and optima."""
    assert len(tmgh.PROBLEMS) == len(jmgh.PROBLEMS) == 19
    for a, b in zip(tmgh.PROBLEMS, jmgh.PROBLEMS):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        da.pop("residual"), db.pop("residual")
        assert da == db


@pytest.mark.parametrize("number", NUMBERS)
def test_mgh_problem_matches_jax(suites, number):
    """Each problem: the same verdict as the JAX package's; a problem that
    reaches its optimum reaches it in both, 2 * final cost within 1e-8
    relative of the JAX package's where the optimum is above 0 and under
    1e-20 in both where it is 0; #2 stops at the same local minimum, to
    1e-8. #16 is held by test_brown_dennis_crawls_as_the_jax_package_does."""
    ok, achieved, s = suites[0][number]
    ok_ref, achieved_ref, s_ref = suites[1][number]
    assert ok == ok_ref == (number not in MISSES)
    assert s.linear_solver_type_used == ctt.LinearSolverType.DENSE_QR
    assert s.linear_solver_type_used.name == s_ref.linear_solver_type_used.name
    optimal = tmgh.PROBLEMS[number - 1].unconstrained_optimal_cost
    if number == 16:
        return
    if optimal > 0 or number == 2:
        assert achieved == pytest.approx(achieved_ref, rel=1e-8)
    else:
        assert achieved < 1e-20 and achieved_ref < 1e-20


def test_brown_dennis_crawls_as_the_jax_package_does(suites):
    """#16 takes all 1,001 rows in both packages and misses the optimum.
    Its crawl amplifies rounding about tenfold every five rows: the JAX
    package's own solve from a start one ulp away parts from it by 4e-12
    at row 40 and by 0.4% at the end. So the first 40 rows agree to 1e-9
    relative, and the ends (544293.19 in the JAX package) within 5% of
    each other, both at least five times the optimum."""
    _, achieved, s = suites[0][16]
    _, achieved_ref, s_ref = suites[1][16]
    assert len(s.iterations) == len(s_ref.iterations) == 1001
    for a, c in zip(s_ref.iterations[:40], s.iterations[:40]):
        assert c.cost == pytest.approx(a.cost, rel=1e-9)
    assert achieved == pytest.approx(achieved_ref, rel=5e-2)
    assert min(achieved, achieved_ref) > 5 * tmgh.PROBLEMS[15].unconstrained_optimal_cost


# The row at which the JAX package's own host-loop solve from a start one
# ulp above parts from its solve from the start (a row cost more than 1e-9
# relative and 1e-20 absolute away), less two: its rounding, amplified by
# an ill-conditioned Jacobian or a crawl near the optimum at the corpus's
# tolerances of 1e-18, decides the rows from there on, and a few ulps of
# difference reach it a row or two sooner than one.
PARTS = {2: 24, 5: 0, 6: 4, 8: 7, 10: 149, 14: 75, 15: 29, 16: 55, 17: 21, 18: 13,
         19: 26}


@pytest.mark.parametrize("number", NUMBERS)
def test_mgh_host_loop_matches_jax(host_suites, number):
    """With default options both packages take the host loop: the same
    verdict and final cost (as test_mgh_problem_matches_jax holds them),
    each row's cost within 1e-9 relative or 1e-20 absolute (the optimum
    of several problems is 0) up to PARTS's row, or where the optimum is
    0 up to the first row under 1e-20 (from there the rows are rounding
    and end at different rows), and elsewhere the same rows and
    termination."""
    ok, achieved, s = host_suites[0][number]
    ok_ref, achieved_ref, s_ref = host_suites[1][number]
    assert ok == ok_ref == (number not in MISSES)
    optimal = tmgh.PROBLEMS[number - 1].unconstrained_optimal_cost
    rows = PARTS.get(number)
    if rows is None and optimal == 0:
        rows = next(i for i, r in enumerate(s_ref.iterations) if r.cost < 1e-20)
    if rows is None:
        assert len(s.iterations) == len(s_ref.iterations)
        assert s.termination_type.name == s_ref.termination_type.name
    for a, c in zip(s_ref.iterations[:rows], s.iterations[:rows]):
        assert c.cost == pytest.approx(a.cost, rel=1e-9, abs=1e-20)
    if number == 16:
        assert achieved == pytest.approx(achieved_ref, rel=5e-2)
    elif optimal > 0 or number == 2:
        assert achieved == pytest.approx(achieved_ref, rel=1e-8)
    else:
        assert achieved < 1e-20 and achieved_ref < 1e-20


def test_run_suite_reaches_17_of_19_with_dense_normal_cholesky():
    """run_suite with DENSE_NORMAL_CHOLESKY in the fused loop: the same 17
    successes."""
    res = tmgh.run_suite(device="cpu", options_overrides={
        "linear_solver_type": ctt.LinearSolverType.DENSE_NORMAL_CHOLESKY, **_FUSED})
    assert sorted(res) == NUMBERS
    assert {n for n, row in res.items() if not row[0]} == MISSES


def test_build_problem_returns_the_block_solve_writes():
    """build_problem scales the start by 10^trial into one (1, n) block, and
    solve writes the answer there: Rosenbrock's optimum (1, 1) to 1e-8."""
    prob, x = tmgh.build_problem(tmgh.PROBLEMS[0], trial=1)
    np.testing.assert_array_equal(x, [[-12.0, 10.0]])
    s = ctt.solve(ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_QR,
                              max_num_iterations=200), prob, device="cpu")
    assert s.termination_type == ctt.TerminationType.CONVERGENCE
    np.testing.assert_allclose(x, [[1.0, 1.0]], rtol=1e-8)
