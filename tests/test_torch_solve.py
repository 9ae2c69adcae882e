"""The slice as a whole: ceres_tpu_torch.solve (DENSE_SCHUR, LM, the
fused-loop form, plain kernel versions on the CPU) against ceres_tpu.solve
on the same BAL problem, at the tolerances of the JAX package's own
fused-vs-host test (tests/test_fused_lm.py:33-49). Costs and residuals are
compared, not raw parameters: bundle adjustment has gauge freedom."""
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.models import bal as jbal

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.ops import kernels as kn


def small_bal():
    b = jbal.synthetic_bal(num_cameras=4, num_points=300, visibility=0.5, seed=0)
    return jbal.perturb(b, 0.01, 0.05, 0.05, seed=1)


def port_problem(b):
    return tbal.build_problem_batched(tbal.from_arrays(
        b.cameras, b.points, b.camera_index, b.point_index, b.observations))


@pytest.fixture(scope="module")
def solved():
    b = small_bal()
    # ceres_tpu.solve writes back into its arrays: give each solve a copy
    jb = jbal.BALProblem(b.cameras.copy(), b.points.copy(), b.camera_index,
                         b.point_index, b.observations)
    jprob, jcams, jpts = jbal.build_problem_batched(jb)
    ref = ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
                              fused_loop="NEVER"), jprob)
    tprob, tcams, tpts = port_problem(b)
    kn.reset_counts()
    out = ctt.solve(ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR),
                    tprob, device="cpu")
    counts = {k.__name__: (k.launches, k.plain_calls) for k in kn.KERNELS}
    return dict(b=b, ref=ref, out=out, jcams=jcams, jpts=jpts, tcams=tcams,
                tpts=tpts, counts=counts)


def test_solve_matches_jax_trajectory(solved):
    ref, out = solved["ref"], solved["out"]
    assert out.termination_type.name == ref.termination_type.name
    assert out.num_successful_steps == ref.num_successful_steps
    assert len(out.iterations) == len(ref.iterations)
    for ih, it in zip(ref.iterations, out.iterations):
        if ih.cost == 0.0:  # host-loop tolerance-break rows leave cost unset
            continue
        assert it.cost == pytest.approx(ih.cost, rel=1e-9, abs=1e-12)
        assert it.trust_region_radius == pytest.approx(ih.trust_region_radius,
                                                       rel=1e-9)
    assert out.final_cost == pytest.approx(ref.final_cost, rel=1e-8, abs=1e-12)


def test_solve_writes_back_a_solution_of_the_same_cost(solved):
    """The arrays the port wrote back evaluate, in ceres_tpu, to its final
    cost, and match ceres_tpu's own solution's cost to 1e-8."""
    b = solved["b"]
    sol = jbal.BALProblem(solved["tcams"], solved["tpts"], b.camera_index,
                          b.point_index, b.observations)
    cost = jbal.build_problem_batched(sol)[0].evaluate()
    assert cost == pytest.approx(solved["out"].final_cost, rel=1e-10)
    assert cost == pytest.approx(solved["ref"].final_cost, rel=1e-8)
    assert not np.array_equal(solved["tcams"], b.cameras)


def test_solve_counts_kernels_and_host_syncs(solved):
    """On the CPU every kernel runs its plain version, at least once per
    iteration, and the loop waits for the device once per iteration plus
    once before the first."""
    out = solved["out"]
    n_it = len(out.iterations) - 1
    assert out.num_host_syncs == n_it + 1
    for name, (launches, plain) in solved["counts"].items():
        assert launches == 0
        assert plain >= n_it, name


def test_float32_solve_reaches_the_float64_cost(solved):
    """evaluation_dtype="float32" goes through the same kernels in float32,
    with the f32 reduced solve plus one refinement pass; its final cost is
    within 1e-5 relative of the float64 solve's."""
    tprob, _, _ = port_problem(solved["b"])
    s32 = ctt.solve(ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                                evaluation_dtype="float32"), tprob, device="cpu")
    assert s32.is_solution_usable()
    assert s32.final_cost == pytest.approx(solved["out"].final_cost, rel=1e-5)
