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
               dict(min_trust_region_radius=1e20, max_trust_region_radius=1e10)]:
        ok_ref, _ = ct.Options(**kw).is_valid()
        ok, _ = ctt.Options(**kw).is_valid()
        assert ok == ok_ref is False
    assert ctt.Options().is_valid() == (True, "")


@pytest.mark.parametrize("kw,slice_no", [
    (dict(linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR), 2),
    (dict(linear_solver_type=ctt.LinearSolverType.CGNR), 6),
    (dict(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
          evaluation_dtype="mixed"), 5),
    (dict(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
          fused_loop="NEVER"), 6),
])
def test_unported_options_raise_naming_the_slice(kw, slice_no):
    problem = tbal.build_problem_batched(tbal.from_arrays(*_arrays(small_bal())))[0]
    with pytest.raises(NotImplementedError, match=f"port slice {slice_no}"):
        ctt.solve(ctt.Options(**kw), problem, device="cpu")


def _arrays(b):
    return b.cameras, b.points, b.camera_index, b.point_index, b.observations
