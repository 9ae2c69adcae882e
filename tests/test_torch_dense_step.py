"""The DENSE_QR and DENSE_NORMAL_CHOLESKY steps of ceres_tpu_torch
(solvers/fused_lm.DenseStepOps) against ceres_tpu's fused loop on the same
problems, on the CPU, and the fallback of DENSE_SCHUR to DENSE_QR on a
problem without eliminable blocks. float64; each solve passes
fused_loop="ALWAYS" in both packages (their AUTO sends problems this
small to the host loop, which tests/test_torch_trust_region.py holds).
Each tolerance is stated where it is used."""
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


def ba():
    """6 cameras, 60 points (the JAX package's make_ba, tests/test_fused_lm.py:15)."""
    return jbal.perturb(jbal.synthetic_bal(num_cameras=6, num_points=60, visibility=0.5,
                                           noise=0.1, seed=3), 0.01, 0.05, 0.05)


def jax_ba(b):
    return jbal.build_problem_batched(jbal.BALProblem(
        b.cameras.copy(), b.points.copy(), b.camera_index, b.point_index,
        b.observations))[0]


def port_ba(b):
    return tbal.build_problem_batched(tbal.from_arrays(
        b.cameras, b.points, b.camera_index, b.point_index, b.observations))[0]


def assert_rows_match(out, ref, rel=1e-9, abs_=0.0):
    """The same termination and rows; each row's cost and radius to `rel`
    relative (or `abs_` absolute, for costs that fall to zero)."""
    assert out.termination_type.name == ref.termination_type.name
    assert len(out.iterations) == len(ref.iterations)
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=rel, abs=abs_)
        assert c.trust_region_radius == pytest.approx(a.trust_region_radius, rel=rel)
        assert c.step_is_successful == a.step_is_successful
        assert c.linear_solver_iterations == a.linear_solver_iterations
    assert out.final_cost == pytest.approx(ref.final_cost, rel=rel, abs=abs_)


@pytest.fixture(scope="module")
def ba_solved():
    b = ba()
    out = {}
    for lst in ("DENSE_QR", "DENSE_NORMAL_CHOLESKY"):
        ref = ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType[lst],
                                  fused_loop="ALWAYS"), jax_ba(b))
        kn.reset_counts()
        s = ctt.solve(ctt.Options(fused_loop="ALWAYS",
                                  linear_solver_type=ctt.LinearSolverType[lst]),
                      port_ba(b), device="cpu")
        out[lst] = (ref, s, {k.__name__: k.plain_calls for k in kn.KERNELS})
    return out


@pytest.mark.parametrize("lst", ["DENSE_QR", "DENSE_NORMAL_CHOLESKY"])
def test_dense_solve_matches_jax_row_for_row(ba_solved, lst):
    """On the 6-camera, 60-point BA problem (tangent 234 wide): the same
    termination and rows, each row's cost and radius to 1e-9 relative."""
    ref, out, _ = ba_solved[lst]
    assert_rows_match(out, ref)
    assert out.linear_solver_type_used.name == ref.linear_solver_type_used.name == lst
    assert out.preconditioner_type_used.name == ref.preconditioner_type_used.name
    assert out.schur_structure_used == ""


@pytest.mark.parametrize("lst", ["DENSE_QR", "DENSE_NORMAL_CHOLESKY"])
def test_dense_solve_runs_no_kernel(ba_solved, lst):
    """The dense step evaluates through _eval_core and solves through
    torch.linalg, as the JAX package's does: no kernel of the Schur or
    CGNR paths runs; one host sync per LM iteration and one before."""
    _, out, plain = ba_solved[lst]
    assert all(v == 0 for v in plain.values()), plain
    assert out.num_host_syncs == len(out.iterations)


@pytest.mark.parametrize("number", [1, 7, 14, 19])
@pytest.mark.parametrize("lst", ["DENSE_QR", "DENSE_NORMAL_CHOLESKY"])
def test_dense_solve_on_mgh_matches_jax_row_for_row(lst, number):
    """MGH problems (one parameter block of 2 to 11) with the default
    tolerances: the same rows, each cost to 1e-9 relative or 1e-20 absolute
    (the costs of #1, #7 and #14 fall to zero) and radius to 1e-9. (The
    corpus's tolerances of 1e-18 run on past the minimum, where each row's
    cost change is rounding and the two packages stop at different rows:
    tests/test_torch_mgh.py holds their final costs.)"""
    kw = dict(linear_solver_type=lst, function_tolerance=1e-6, parameter_tolerance=1e-8,
              gradient_tolerance=1e-10)
    _, _, ref = jmgh.solve_problem(jmgh.PROBLEMS[number - 1], options_overrides=dict(
        kw, linear_solver_type=ct.LinearSolverType[lst], fused_loop="ALWAYS"))
    _, _, out = tmgh.solve_problem(tmgh.PROBLEMS[number - 1], device="cpu",
                                   options_overrides=dict(
                                       kw, linear_solver_type=ctt.LinearSolverType[lst],
                                       fused_loop="ALWAYS"))
    assert_rows_match(out, ref, abs_=1e-20)


def test_dense_schur_without_e_blocks_falls_back_to_dense_qr():
    """DENSE_SCHUR on a problem of one parameter block (no eliminable block
    set) runs DENSE_QR, as LinearSolverForZeroEBlocks makes the JAX package
    do: the solver used and the rows match (costs to 1e-9 relative or
    1e-20 absolute), and the DENSE_QR solve's rows are the same."""
    p = 12  # Box 3D
    _, _, ref = jmgh.solve_problem(jmgh.PROBLEMS[p], options_overrides=dict(
        linear_solver_type=ct.LinearSolverType.DENSE_SCHUR, fused_loop="ALWAYS"))
    _, _, out = tmgh.solve_problem(tmgh.PROBLEMS[p], device="cpu", options_overrides=dict(
        linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR, fused_loop="ALWAYS"))
    _, _, qr = tmgh.solve_problem(tmgh.PROBLEMS[p], device="cpu",
                                  options_overrides=dict(fused_loop="ALWAYS"))
    assert out.linear_solver_type_given == ctt.LinearSolverType.DENSE_SCHUR
    assert out.linear_solver_type_used.name == ref.linear_solver_type_used.name == "DENSE_QR"
    assert out.schur_structure_used == ref.schur_structure_used == ""
    assert_rows_match(out, ref, abs_=1e-20)
    assert [r.cost for r in out.iterations] == [r.cost for r in qr.iterations]


def test_dense_solve_writes_back_its_solution():
    """solve writes the answer into the caller's parameter block, and its
    cost there is the final cost (1e-12 relative)."""
    prob, x = tmgh.build_problem(tmgh.PROBLEMS[18])
    s = ctt.solve(ctt.Options(fused_loop="ALWAYS",
                              linear_solver_type=ctt.LinearSolverType.DENSE_QR), prob,
                  device="cpu")
    assert not np.array_equal(x[0], np.asarray(tmgh.PROBLEMS[18].initial_x))
    r = tmgh.PROBLEMS[18].residual(torch.as_tensor(x[0]))
    assert 0.5 * float(torch.sum(r * r)) == pytest.approx(s.final_cost, rel=1e-12)
