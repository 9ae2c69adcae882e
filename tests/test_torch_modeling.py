"""ceres_tpu_torch's modeling core against ceres_tpu on the same inputs:
rotation, the Snavely residual in both its forms, the BAL generator, the
program's plain evaluation and its option handling. All on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu import rotation as jrot
from ceres_tpu.models import bal as jbal
from ceres_tpu.program import CompiledProgram as JaxProgram

import ceres_tpu_torch as ctt
from ceres_tpu_torch import rotation as trot
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.program import CompiledProgram
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def small_bal(seed=0):
    b = jbal.synthetic_bal(num_cameras=4, num_points=300, visibility=0.5, seed=seed)
    return jbal.perturb(b, 0.01, 0.05, 0.05, seed=1)


def test_angle_axis_rotate_point_matches_jax():
    """float64, 1e-12: the same formula, both branches (the last rows sit
    below theta^2 <= eps, on the first-order branch)."""
    rng = np.random.default_rng(0)
    aa = rng.standard_normal((64, 3)) * 0.5
    aa[-4:] *= 1e-9
    pts = rng.standard_normal((64, 3)) * 3.0
    ref = np.asarray(jrot.angle_axis_rotate_point(jnp.asarray(aa), jnp.asarray(pts)))
    out = trot.angle_axis_rotate_point(torch.as_tensor(aa), torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("form", ["branchy", "rows"])
def test_snavely_residual_matches_jax(form):
    """float64, 1e-12 relative to the pixel scale. The rows form (branch-
    free Rodrigues, the function the eval_fused kernel computes) differs
    from the branchy form only by O(1e-30 / theta^2) terms."""
    b = small_bal()
    cams = b.cameras[b.camera_index]
    pts = b.points[b.point_index]
    obs = b.observations
    ref = np.asarray(jax.vmap(jbal.snavely_reprojection_residual)(
        jnp.asarray(cams), jnp.asarray(pts), jnp.asarray(obs)))
    tc, tp, to = (torch.as_tensor(a) for a in (cams, pts, obs))
    if form == "branchy":
        out = torch.func.vmap(tbal.snavely_reprojection_residual)(tc, tp, to)
    else:
        out = tbal.snavely_residual_rows(tc.T, tp.T, to.T).T
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12 * scale)


def test_synthetic_bal_and_perturb_match_jax():
    """Same seeds, same numbers: structure exactly, values to 1e-12 (the
    clean observations come from each package's own float64 residual)."""
    ref = small_bal(seed=3)
    out = tbal.perturb(tbal.synthetic_bal(num_cameras=4, num_points=300,
                                          visibility=0.5, seed=3),
                       0.01, 0.05, 0.05, seed=1)
    np.testing.assert_array_equal(out.camera_index, ref.camera_index)
    np.testing.assert_array_equal(out.point_index, ref.point_index)
    np.testing.assert_allclose(out.cameras, ref.cameras, rtol=1e-12, atol=0)
    np.testing.assert_allclose(out.points, ref.points, rtol=1e-12, atol=0)
    np.testing.assert_allclose(out.observations, ref.observations, rtol=1e-12,
                               atol=1e-12)


def test_from_arrays_copies_the_problem():
    ref = small_bal()
    out = tbal.from_arrays(ref.cameras, ref.points, ref.camera_index,
                           ref.point_index, ref.observations)
    assert out.num_observations == ref.num_observations
    out.cameras[0, 0] += 1.0
    assert out.cameras[0, 0] != ref.cameras[0, 0]


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
def test_plain_evaluation_matches_jax_program(dtype, tol):
    """CompiledProgram._eval_core (vmap of jacfwd over the cost's own
    residual) against the JAX program's evaluation, rows sorted by point
    in both. Tolerance relative to each output's largest entry: 1e-12 in
    float64, 1e-5 in float32 (float32 rounding of different op orders)."""
    b = small_bal()
    jprog = JaxProgram(jbal.build_problem_batched(b)[0], compute_dtype=dtype,
                       sort_rows=True)
    o_ref = jprog._eval_core(jprog.initial_state(), True, False, need_grad=False)
    prog = CompiledProgram(tbal.build_problem_batched(tbal.from_arrays(
        b.cameras, b.points, b.camera_index, b.point_index, b.observations))[0],
        dtype, device="cpu")
    o = prog._eval_core(prog.initial_state())
    pairs = [(o["residuals"], o_ref["residuals"])] + list(
        zip(o["block_jacs"][0], o_ref["block_jacs"][0]))
    for out, ref in pairs:
        ref = np.asarray(ref, np.float64)
        err = np.abs(out.double().numpy() - ref).max()
        assert err <= tol * np.abs(ref).max()
    assert float(o["cost"]) == pytest.approx(float(o_ref["cost"]), rel=tol)


def test_options_validation_matches_jax():
    for kw in [dict(max_num_iterations=-1), dict(min_lm_diagonal=0.0),
               dict(evaluation_dtype="float16"),
               dict(min_trust_region_radius=1e20, max_trust_region_radius=1e10),
               dict(eta=0.0), dict(use_mixed_precision_solves=True,
                                   linear_solver_type="ITERATIVE_SCHUR"),
               dict(max_solver_time_in_seconds=-1.0)]:
        ok_ref, _ = ct.Options(**_enums(ct, kw)).is_valid()
        ok, _ = ctt.Options(**_enums(ctt, kw)).is_valid()
        assert ok == ok_ref is False
    assert ctt.Options().is_valid() == (True, "")


def _enums(pkg, kw):
    """kw with a linear solver named by string made that package's enum."""
    if "linear_solver_type" in kw:
        kw = dict(kw, linear_solver_type=pkg.LinearSolverType.parse(
            kw["linear_solver_type"]))
    return kw


_IS = ctt.LinearSolverType.ITERATIVE_SCHUR
_PT = ctt.PreconditionerType


@pytest.mark.parametrize("kw,slice_no", [
    (dict(linear_solver_type=_IS,
          preconditioner_type=_PT.SCHUR_POWER_SERIES_EXPANSION), 6),
    (dict(linear_solver_type=ctt.LinearSolverType.SPARSE_NORMAL_CHOLESKY), 6),
    (dict(linear_solver_type=ctt.LinearSolverType.CGNR,
          preconditioner_type=_PT.CLUSTER_JACOBI), 6),
    (dict(linear_solver_type=ctt.LinearSolverType.SPARSE_SCHUR), 6),
    (dict(linear_solver_type=_IS, preconditioner_type=_PT.CLUSTER_JACOBI), 6),
    (dict(linear_solver_type=_IS, preconditioner_type=_PT.CLUSTER_TRIDIAGONAL), 6),
    (dict(linear_solver_type=_IS, preconditioner_type=_PT.SUBSET), 6),
    (dict(linear_solver_type=_IS, use_spse_initialization=True), 6),
    (dict(linear_solver_type=_IS, use_explicit_schur_complement=True), 6),
])
def test_unported_options_raise_naming_the_slice(kw, slice_no):
    problem = tbal.build_problem_batched(tbal.from_arrays(*_arrays(small_bal())))[0]
    with pytest.raises(NotImplementedError, match=f"port slice {slice_no}"):
        ctt.solve(ctt.Options(**kw), problem, device="cpu")


def _arrays(b):
    return b.cameras, b.points, b.camera_index, b.point_index, b.observations


class _Counting:
    """An EvaluationCallback of either package that counts its calls."""

    def __init__(self):
        self.calls = 0

    def prepare_for_evaluation(self, evaluate_jacobians, new_evaluation_point):
        self.calls += 1


_DS = "DENSE_SCHUR"


@pytest.mark.parametrize("case", [
    "dogleg_iterative_schur", "dogleg_cgnr", "callbacks", "evaluation_callback",
    "update_state_every_iteration", "fused_loop_never"])
def test_host_loop_options_match_jax(case):
    """The six options that ran only in the JAX package's host loop, on
    small_bal() in both packages: DOGLEG with ITERATIVE_SCHUR or CGNR
    fails the JAX package's validation, and the port's, with its message;
    the others run the host loop to the JAX package's rows, each row's
    cost within 1e-9 relative, the same termination and message, the
    evaluation callback called as often, the state written back."""
    kw = {"dogleg_iterative_schur": dict(linear_solver_type="ITERATIVE_SCHUR", dogleg=True),
          "dogleg_cgnr": dict(linear_solver_type="CGNR", dogleg=True),
          "callbacks": dict(callbacks=[lambda it: None]),
          "evaluation_callback": dict(evaluation_callback=True),
          "update_state_every_iteration": dict(update_state_every_iteration=True),
          "fused_loop_never": dict(fused_loop="NEVER")}[case]
    runs = []
    for pkg, build in [(ct, lambda b: jbal.build_problem_batched(jbal.BALProblem(
            b.cameras.copy(), b.points.copy(), b.camera_index, b.point_index,
            b.observations))), (ctt, lambda b: tbal.build_problem_batched(
            tbal.from_arrays(*_arrays(b))))]:
        opts = dict(kw)
        opts["linear_solver_type"] = pkg.LinearSolverType[opts.get("linear_solver_type", _DS)]
        if opts.pop("dogleg", False):
            opts["trust_region_strategy_type"] = pkg.TrustRegionStrategyType.DOGLEG
        if opts.get("evaluation_callback"):
            opts["evaluation_callback"] = _Counting()
        problem, cams, pts = build(small_bal())
        extra = {} if pkg is ct else {"device": "cpu"}
        s = pkg.solve(pkg.Options(**opts), problem, **extra)
        runs.append((s, opts.get("evaluation_callback"), np.array(pts)))
    (ref, ref_cb, ref_pts), (out, cb, out_pts) = runs
    assert out.termination_type.name == ref.termination_type.name
    assert out.message == ref.message
    if case.startswith("dogleg"):
        assert out.termination_type == ctt.TerminationType.FAILURE
        assert out.message == "DOGLEG only supports exact factorization-based linear solvers"
        return
    assert len(out.iterations) == len(ref.iterations)
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9)
    if cb is not None:
        assert cb.calls == ref_cb.calls == out.num_jacobian_evaluations
    np.testing.assert_allclose(out_pts, ref_pts, rtol=1e-9, atol=1e-12)
