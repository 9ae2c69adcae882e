"""Box bounds in the port's fused loop: the projection of
x0, the active-set mask on the Jacobi scale and the projected Armijo line
search, against the JAX fused loop on a box-bounded BA problem (the jt
path) and on the constrained More-Garbow-Hillstrom problems (the dense
solvers), problem by problem. Each tolerance is stated where it is used."""
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.models import bal as jbal
from ceres_tpu.models import mgh as jmgh

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.models import mgh as tmgh
from ceres_tpu_torch.ops import kernels as kn


def small_ba():
    return tbal.perturb(tbal.synthetic_bal(num_cameras=5, num_points=80, visibility=0.5,
                                           seed=3), 0.01, 0.05, 0.2)


def point_box(b, lo_pct=2.0, hi_pct=98.0):
    """Per coordinate, the lo_pct to hi_pct percentiles of the start
    points: the box of the box-bounded BA path."""
    return (np.percentile(b.points, lo_pct, axis=0),
            np.percentile(b.points, hi_pct, axis=0))


def bounded(P, bal_mod, b):
    arrays = (b.cameras.copy(), b.points.copy(), b.camera_index.copy(),
              b.point_index.copy(), b.observations.copy())
    p, cams, pts = bal_mod.build_problem_batched(bal_mod.BALProblem(*arrays))
    lo, hi = point_box(b)
    p.set_parameter_block_array_bounds(p.parameter_block_arrays()[1], lower=lo, upper=hi)
    return p, pts


@pytest.fixture(scope="module")
def bounded_solves():
    b = small_ba()
    out = {}
    for dtype in ("float64", "float32"):
        jp, jpts = bounded(ct, jbal, b)
        ref = ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
                                  evaluation_dtype=dtype, fused_loop="ALWAYS"), jp)
        tp, tpts = bounded(ctt, tbal, b)
        kn.reset_counts()
        s = ctt.solve(ctt.Options(fused_loop="ALWAYS",
                                  linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                                  evaluation_dtype=dtype), tp, device="cpu")
        out[dtype] = (ref, jpts, s, tpts, kn.eval_fused.plain_calls)
    return b, out


def test_start_box_clips_some_coordinates():
    """The box clips part of the start points (the path's premise)."""
    b = small_ba()
    lo, hi = point_box(b)
    clipped = np.mean((b.points < lo) | (b.points > hi))
    assert 0.02 < clipped < 0.08


def test_bounded_ba_matches_jax(bounded_solves):
    """Path (b), float64: the same termination and rows, each row's cost to
    1e-9 relative; every point inside its box, and the same coordinates on
    a bound as in the JAX answer; the jt path evaluated (eval_fused's
    plain version)."""
    b, out = bounded_solves
    ref, jpts, s, tpts, evals = out["float64"]
    assert s.is_constrained and ref.is_constrained
    assert s.termination_type.name == ref.termination_type.name
    assert len(s.iterations) == len(ref.iterations)
    for a, c in zip(ref.iterations, s.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9)
    lo, hi = point_box(b)
    assert np.all(tpts >= lo) and np.all(tpts <= hi)
    on_t = (tpts == lo) | (tpts == hi)
    on_j = (jpts == lo) | (jpts == hi)
    assert on_t.sum() > 0
    np.testing.assert_array_equal(on_t, on_j)
    assert evals > 0


def test_bounded_ba_float32_final_cost(bounded_solves):
    """Path (b), float32: the final cost within 1e-5 of the JAX one, and
    every point inside its box."""
    b, out = bounded_solves
    ref, _, s, tpts, _ = out["float32"]
    assert s.final_cost == pytest.approx(ref.final_cost, rel=1e-5)
    lo, hi = point_box(b)
    assert np.all(tpts >= lo) and np.all(tpts <= hi)


def test_line_search_syncs_once_per_probe(bounded_solves):
    """A bounded solve waits for the device once before the loop, once per
    iteration for its candidate, and once per probe of the line search:
    at least one probe an iteration, at most
    max_num_line_search_step_size_iterations."""
    _, out = bounded_solves
    s = out["float64"][2]
    n_it = len(s.iterations) - 1
    assert 1 + 2 * n_it <= s.num_host_syncs <= 1 + n_it * (1 + 20)


def test_x0_is_projected_and_active_coordinates_hold():
    """A start outside the box is projected onto it; a coordinate whose
    gradient pushes it out of the box stays on its bound."""
    p = ctt.Problem()
    v = np.array([[5.0, -4.0]])
    arr = p.add_parameter_block_array(v)
    p.set_parameter_block_array_bounds(arr, lower=[-1.0, -1.0], upper=[1.0, 1.0])
    p.add_residual_block_batch(ctt.AutoDiffCostFunction(lambda x: x - 3.0, 2, [2]), None,
                               [(arr, np.zeros(1, np.int64))])
    s = ctt.solve(ctt.Options(fused_loop="ALWAYS",
                              linear_solver_type=ctt.LinearSolverType.DENSE_QR), p,
                  device="cpu")
    assert s.initial_cost == pytest.approx(0.5 * (4.0 + 16.0))
    np.testing.assert_allclose(v, [[1.0, 1.0]])


# ------------------------------------------------- the constrained MGH problems

CONSTRAINED = [p.number for p in tmgh.PROBLEMS if p.constrained_optimal_cost is not None]
CONFIGS = {"DENSE_QR": {}, "DENSE_NORMAL_CHOLESKY": {},
           "DENSE_NORMAL_CHOLESKY_mixed": {"use_mixed_precision_solves": True}}


def test_nine_constrained_problems():
    assert len(CONSTRAINED) == 9


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("number", CONSTRAINED)
def test_constrained_mgh_matches_jax(number, config):
    """Path (g): each constrained problem solved as the JAX fused loop solves
    it (solve_problem(constrained=True)), DENSE_QR, DENSE_NORMAL_CHOLESKY
    and that with mixed-precision solves: the same success by the
    reference's 4-digit criterion, and the same final cost to 1e-8
    relative (the iteration counts of the last rows, where the cost sits
    at its floor under 1e-18 tolerances, follow rounding)."""
    lst = config.split("_mixed")[0]
    extra = CONFIGS[config]
    jp = next(p for p in jmgh.PROBLEMS if p.number == number)
    tp = next(p for p in tmgh.PROBLEMS if p.number == number)
    jok, jach, js = jmgh.solve_problem(jp, True, options_overrides=dict(
        extra, linear_solver_type=ct.LinearSolverType[lst], fused_loop="ALWAYS"))
    tok, tach, ts = tmgh.solve_problem(tp, True, options_overrides=dict(
        extra, linear_solver_type=ctt.LinearSolverType[lst]), device="cpu")
    assert tok == jok
    assert ts.termination_type.name == js.termination_type.name
    assert tach == pytest.approx(jach, rel=1e-8, abs=1e-300)
    assert ts.is_constrained


def test_run_suite_constrained():
    """run_suite(constrained=True) solves all nine."""
    assert tmgh.run_suite(constrained=True, device="cpu") == {n: [True] for n in CONSTRAINED}
