"""The dense linear solvers and the dense Jacobian of ceres_tpu_torch against
ceres_tpu on the same inputs, on the CPU: qr_solve and
normal_cholesky_solve (solvers/linear/dense.py) on the canned problems of
models/test_problems.py and on a seeded random system, and the dense
(N, tangent) Jacobian scattered from the blocks (ops/bsr.py) against the
JAX program's own. float64; each tolerance is stated where it is used."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu.models import bal as jbal
from ceres_tpu.models import mgh as jmgh
from ceres_tpu.models import test_problems as jtp
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers.linear import dense as jdense

from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.models import mgh as tmgh
from ceres_tpu_torch.models import test_problems as ttp
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.solvers.linear import dense as tdense


def random_system():
    """A seeded overdetermined system of 40 rows and 7 columns."""
    rng = np.random.default_rng(11)
    return rng.standard_normal((40, 7)), rng.standard_normal(40), rng.uniform(0.1, 2.0, 7)


def systems():
    out = {f"problem_{pid}": ttp.create_linear_least_squares_problem(pid)
           for pid in ttp.PROBLEMS}
    out["random"] = ttp.LinearLeastSquaresProblem(*random_system())
    return out


def rel_err(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("pid", sorted(jtp.PROBLEMS))
def test_canned_problems_match_jax(pid):
    """models/test_problems.py builds the JAX module's systems exactly."""
    a, b = ttp.create_linear_least_squares_problem(pid), jtp.create_linear_least_squares_problem(pid)
    for name in ("J", "b", "D", "x_expected"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.num_eliminate_cols == b.num_eliminate_cols


@pytest.mark.parametrize("name", ["problem_0", "problem_1", "problem_2", "random"])
@pytest.mark.parametrize("solver", ["qr_solve", "normal_cholesky_solve"])
def test_dense_solve_matches_jax(solver, name):
    """y minimising |J y - b|^2 + |D y|^2 against the JAX function on the
    same system: 1e-12 relative; and against the solution of the normal
    equations where the problem knows it: 1e-12 relative."""
    p = systems()[name]
    out = getattr(tdense, solver)(torch.as_tensor(p.J), torch.as_tensor(p.b),
                                  torch.as_tensor(p.D))
    ref = getattr(jdense, solver)(jnp.asarray(p.J), jnp.asarray(p.b), jnp.asarray(p.D))
    assert out.dtype == torch.float64 and out.shape == (p.J.shape[1],)
    assert rel_err(out, ref) <= 1e-12
    x = p.x_expected if p.x_expected is not None else np.linalg.solve(
        p.J.T @ p.J + np.diag(p.D * p.D), p.J.T @ p.b)
    assert rel_err(out, x) <= 1e-12


def test_normal_cholesky_of_a_singular_system_is_nan():
    """A failed factorisation comes out NaN without a host sync, which the
    LM loop reads as an invalid step (a zero column of J and D = 0: a zero
    pivot)."""
    J = torch.tensor([[1.0, 0.0], [1.0, 0.0]], dtype=torch.float64)
    y = tdense.normal_cholesky_solve(J, torch.ones(2, dtype=torch.float64),
                                     torch.zeros(2, dtype=torch.float64))
    assert torch.isnan(y).all()


def _bal():
    return jbal.perturb(jbal.synthetic_bal(num_cameras=5, num_points=40, visibility=0.6,
                                           seed=2), 0.01, 0.05, 0.05, seed=1)


@pytest.mark.parametrize("which", ["bal", "mgh_osborne2"])
def test_dense_jacobian_matches_jax(which):
    """The dense (N, tangent) float64 Jacobian that _eval_core assembles for
    the dense solvers against the JAX program's evaluate_dense (rows sorted
    by point on both sides): 1e-12 relative (on BAL the two evaluations
    differ in the rotation's branch-free form by ~1e-13 relative)."""
    if which == "bal":
        b = _bal()
        jprog = JaxProgram(jbal.build_problem_batched(b)[0], sort_rows=True)
        prog = CompiledProgram(tbal.build_problem_batched(tbal.from_arrays(
            b.cameras, b.points, b.camera_index, b.point_index, b.observations))[0],
            device="cpu")
    else:
        jprog = JaxProgram(jmgh.build_problem(jmgh.PROBLEMS[18])[0], sort_rows=True)
        prog = CompiledProgram(tmgh.build_problem(tmgh.PROBLEMS[18])[0], device="cpu")
    _, r_ref, _, J_ref = jprog.evaluate_dense(jprog.initial_state())
    o = prog._eval_core(prog.initial_state(), dense_jac=True)
    J = o["jacobian"]
    assert J.dtype == torch.float64 and tuple(J.shape) == tuple(J_ref.shape)
    assert rel_err(J, J_ref) <= 1e-12
    assert rel_err(o["residuals"], r_ref) <= 1e-12
    # without dense_jac no dense Jacobian is assembled
    assert "jacobian" not in prog._eval_core(prog.initial_state())
