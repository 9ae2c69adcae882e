"""The host loop's callbacks against the JAX package's on the CPU: an
IterationCallback that ends the solve (SOLVER_TERMINATE_SUCCESSFULLY ->
USER_SUCCESS, SOLVER_ABORT -> USER_FAILURE, the JAX messages), an
EvaluationCallback's call count, update_state_every_iteration (the
problem's arrays hold the iterate at every callback), a mid-solve
mutation raising, max_solver_time_in_seconds, the progress log and the
iteration dumps. A small BAL problem (4 cameras, 60 points) with
DENSE_SCHUR; each tolerance is stated where it is used."""
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.models import bal as jbal
from ceres_tpu.utils import dump as jdump

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.utils import dump as tdump
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _bal():
    b = jbal.synthetic_bal(num_cameras=4, num_points=60, visibility=0.6, seed=7)
    return jbal.perturb(b, 0.01, 0.05, 0.05, seed=1)


def _problem(pkg, b):
    arrays = (b.cameras.copy(), b.points.copy(), b.camera_index.copy(),
              b.point_index.copy(), b.observations.copy())
    if pkg is ct:
        return jbal.build_problem_batched(jbal.BALProblem(*arrays))
    return tbal.build_problem_batched(tbal.from_arrays(*arrays))


def _solve(pkg, make_opts, b=None):
    """(summary, problem, cams, pts) of one solve; make_opts(pkg, problem,
    cams, pts) -> the Options keywords."""
    p, cams, pts = _problem(pkg, b if b is not None else _bal())
    kw = dict(linear_solver_type=pkg.LinearSolverType.DENSE_SCHUR)
    kw.update(make_opts(pkg, p, cams, pts))
    extra = {} if pkg is ct else {"device": "cpu"}
    return pkg.solve(pkg.Options(**kw), p, **extra), p, cams, pts


def _ending(ret_name, at):
    def make(pkg, p, cams, pts):
        def cb(it):
            if it.iteration == at:
                return pkg.CallbackReturnType[ret_name]
            return pkg.CallbackReturnType.SOLVER_CONTINUE
        return dict(callbacks=[cb])
    return make


@pytest.mark.parametrize("ret,at,term", [
    ("SOLVER_TERMINATE_SUCCESSFULLY", 2, "USER_SUCCESS"),
    ("SOLVER_ABORT", 1, "USER_FAILURE")])
def test_iteration_callback_ends_the_solve_as_jax(ret, at, term):
    """The callback's answer at row `at` ends the solve there: the same
    termination, the JAX package's message word for word, at + 1 rows,
    each cost within 1e-9 relative; USER_SUCCESS's solution is usable,
    USER_FAILURE's not."""
    ref = _solve(ct, _ending(ret, at))[0]
    s = _solve(ctt, _ending(ret, at))[0]
    assert s.termination_type.name == ref.termination_type.name == term
    assert s.message == ref.message == f"User callback returned {ret}."
    assert len(s.iterations) == len(ref.iterations) == at + 1
    for a, c in zip(ref.iterations, s.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9)
    assert s.is_solution_usable() == (term == "USER_SUCCESS")


class _Counting:
    def __init__(self):
        self.calls = []

    def prepare_for_evaluation(self, evaluate_jacobians, new_evaluation_point):
        self.calls.append((evaluate_jacobians, new_evaluation_point))


def test_evaluation_callback_and_state_updates_match_jax():
    """The EvaluationCallback runs before every Jacobian evaluation, as
    often as in the JAX package (and as num_jacobian_evaluations says),
    with the same flags; under update_state_every_iteration each
    callback sees the problem's arrays holding that row's iterate, the
    JAX package's to 1e-9 relative (1e-12 absolute)."""
    seen = {}

    def make(pkg, p, cams, pts):
        ev = _Counting()
        rows = seen.setdefault(pkg.__name__, [])

        def cb(it):
            rows.append((it.iteration, np.array(cams), np.array(pts)))
            return pkg.CallbackReturnType.SOLVER_CONTINUE
        return dict(evaluation_callback=ev, callbacks=[cb], update_state_every_iteration=True)

    ref, jp, _, _ = _solve(ct, make)
    s, tp, _, _ = _solve(ctt, make)
    assert s.termination_type.name == ref.termination_type.name
    jrows, trows = seen["ceres_tpu"], seen["ceres_tpu_torch"]
    assert len(s.iterations) == len(ref.iterations)
    # the row a tolerance ends the loop on is appended without callbacks
    assert len(trows) == len(jrows) == len(s.iterations) - 1
    for (ja, jc, jq), (ta, tc, tq) in zip(jrows, trows):
        assert ja == ta
        np.testing.assert_allclose(tc, jc, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(tq, jq, rtol=1e-9, atol=1e-12)
    # the last row's state is not the solution only when the loop returns
    # an earlier, better iterate; here it is the answer written back
    assert s.num_jacobian_evaluations == ref.num_jacobian_evaluations


def test_evaluation_callback_counts_match_jax():
    """The calls of the EvaluationCallback: the JAX package's count, all
    with (evaluate_jacobians, new_evaluation_point) = (True, True)."""
    evs = {}

    def make(pkg, p, cams, pts):
        evs[pkg.__name__] = _Counting()
        return dict(evaluation_callback=evs[pkg.__name__])

    ref = _solve(ct, make)[0]
    s = _solve(ctt, make)[0]
    ref_calls, calls = evs["ceres_tpu"].calls, evs["ceres_tpu_torch"].calls
    assert len(calls) == len(ref_calls) == s.num_jacobian_evaluations > 1
    assert set(calls) == set(ref_calls) == {(True, True)}
    assert len(s.iterations) == len(ref.iterations)


def test_mid_solve_mutation_raises_as_jax():
    """A callback that adds a residual block changes the problem's
    structure under the solve: both packages raise RuntimeError."""
    def make(pkg, p, cams, pts):
        def cb(it):
            if it.iteration == 1:
                blk = np.zeros(3)
                p.add_residual_block(pkg.AutoDiffCostFunction(lambda v: v, 3, [3]), None, [blk])
            return pkg.CallbackReturnType.SOLVER_CONTINUE
        return dict(callbacks=[cb])

    for pkg in (ct, ctt):
        with pytest.raises(RuntimeError, match="modified during Solve"):
            _solve(pkg, make)


def test_max_solver_time_ends_the_solve_as_jax():
    """A time limit the first row already exceeds: NO_CONVERGENCE after
    row 0 in both packages, with the JAX message up to its times."""
    ref = _solve(ct, lambda *a: dict(max_solver_time_in_seconds=1e-9))[0]
    s = _solve(ctt, lambda *a: dict(max_solver_time_in_seconds=1e-9))[0]
    assert s.termination_type.name == ref.termination_type.name == "NO_CONVERGENCE"
    assert len(s.iterations) == len(ref.iterations) == 1
    assert s.message.startswith("Maximum solver time reached. Total solver time: ")
    assert ref.message.split(":")[0] == s.message.split(":")[0]
    assert s.is_solution_usable()


def test_progress_log_prints_each_row(capsys):
    """minimizer_progress_to_stdout under PER_MINIMIZER_ITERATION prints
    one trust-region line per row as it is made (not the row a tolerance
    ends the loop on, appended after the callbacks, as in the JAX loop);
    SILENT prints none."""
    s = _solve(ctt, lambda *a: dict(minimizer_progress_to_stdout=True, fused_loop="NEVER"))[0]
    assert s.termination_type == ctt.TerminationType.CONVERGENCE
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("iter ")]
    assert len(lines) == len(s.iterations) - 1
    assert lines[0].startswith("iter    0  cost ")
    _solve(ctt, lambda pkg, *a: dict(minimizer_progress_to_stdout=True, fused_loop="NEVER",
                                      logging_type=pkg.LoggingType.SILENT))
    assert "iter " not in capsys.readouterr().out


def test_iteration_dumps_match_jax(tmp_path):
    """trust_region_minimizer_iterations_to_dump writes iteration i's J, D,
    b and step in the JAX package's format and names; read back, each
    within 1e-9 relative of the JAX package's dump (1e-12 absolute)."""
    dirs = {}

    def make(pkg, *a):
        d = tmp_path / pkg.__name__
        dirs[pkg.__name__] = d
        return dict(trust_region_minimizer_iterations_to_dump=[1, 2],
                    trust_region_problem_dump_directory=str(d))

    _solve(ct, make)
    _solve(ctt, make)
    for i in (1, 2):
        name = f"ceres_tpu_iteration_{i:03d}"
        ref = jdump.load_linear_least_squares_problem(str(dirs["ceres_tpu"] / name))
        out = tdump.load_linear_least_squares_problem(str(dirs["ceres_tpu_torch"] / name))
        for key in ("J", "D", "b", "x"):
            assert out[key] is not None and ref[key] is not None
            np.testing.assert_allclose(out[key], ref[key], rtol=1e-9, atol=1e-12)
