"""TRADITIONAL and SUBSPACE dogleg in the host loop against the JAX
package's DoglegStrategy on the CPU, on every host-loop tier: DENSE_QR,
DENSE_NORMAL_CHOLESKY and DENSE_SCHUR through solve() with
fused_loop="NEVER"; ITERATIVE_SCHUR and CGNR, which both packages'
Options.is_valid refuse with DOGLEG ("DOGLEG only supports exact
factorization-based linear solvers"), through the host minimizer built
directly over BlockTrustRegionKernels, as the JAX classes allow. A small
BAL problem; each tolerance is stated where it is used."""
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.models import bal as jbal
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers.bsr_kernels import BlockTrustRegionKernels as JaxBlockKernels
from ceres_tpu.solvers.trust_region import TrustRegionMinimizer as JaxMinimizer
from ceres_tpu.utils import ordering as jordering

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.solvers.bsr_kernels import BlockTrustRegionKernels
from ceres_tpu_torch.solvers.trust_region import TrustRegionMinimizer
from ceres_tpu_torch.utils import ordering
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DOGLEGS = ["TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG"]


def _bal(num_points=100):
    b = jbal.synthetic_bal(num_cameras=4, num_points=num_points, visibility=0.5, seed=11)
    return jbal.perturb(b, 0.01, 0.05, 0.05, seed=2)


def _problem(pkg, b):
    arrays = (b.cameras.copy(), b.points.copy(), b.camera_index.copy(),
              b.point_index.copy(), b.observations.copy())
    if pkg is ct:
        return jbal.build_problem_batched(jbal.BALProblem(*arrays))[0]
    return tbal.build_problem_batched(tbal.from_arrays(*arrays))[0]


def _opts(pkg, lst, dogleg, **kw):
    return pkg.Options(linear_solver_type=pkg.LinearSolverType[lst],
                       trust_region_strategy_type=pkg.TrustRegionStrategyType.DOGLEG,
                       dogleg_type=pkg.DoglegType[dogleg], **kw)


# The Gauss-Newton point is solved at mu D^2 with mu = 1e-8, nearly
# unregularized: the normal equations (DENSE_NORMAL_CHOLESKY, and the CG of
# ITERATIVE_SCHUR and CGNR, stopped by eta = 0.1) carry the rounding of
# their products into it, up to 7e-9 relative in a row's cost here, where
# QR and the dense Schur factorization stay under 1e-9.
REL = {"DENSE_QR": 1e-9, "DENSE_SCHUR": 1e-9, "DENSE_NORMAL_CHOLESKY": 1e-7,
       "ITERATIVE_SCHUR": 1e-7, "CGNR": 1e-7}


def _assert_rows_match(s, ref, rel):
    """The same termination, rows and step outcomes; each row's cost within
    `rel` relative, its radius within 1e-6 (the radius update reads the
    step quality, which loses digits to the cost change's cancellation)."""
    assert s.termination_type.name == ref.termination_type.name
    assert len(s.iterations) == len(ref.iterations) > 2
    for a, c in zip(ref.iterations, s.iterations):
        assert c.cost == pytest.approx(a.cost, rel=rel, abs=1e-300)
        assert c.trust_region_radius == pytest.approx(a.trust_region_radius, rel=1e-6)
        assert (c.step_is_valid, c.step_is_successful) == (a.step_is_valid,
                                                           a.step_is_successful)


@pytest.mark.parametrize("dogleg", DOGLEGS)
@pytest.mark.parametrize("lst", ["DENSE_QR", "DENSE_NORMAL_CHOLESKY", "DENSE_SCHUR"])
def test_exact_tier_dogleg_matches_jax(lst, dogleg):
    """solve() with fused_loop="NEVER" in both packages, the dense solvers
    on 50 points (they factor the whole Jacobian); rows to REL."""
    b = _bal(100 if lst == "DENSE_SCHUR" else 50)
    ref = ct.solve(_opts(ct, lst, dogleg, fused_loop="NEVER"), _problem(ct, b))
    s = ctt.solve(_opts(ctt, lst, dogleg, fused_loop="NEVER"), _problem(ctt, b), device="cpu")
    _assert_rows_match(s, ref, REL[lst])
    assert s.final_cost == pytest.approx(ref.final_cost, rel=REL[lst])


@pytest.mark.parametrize("dogleg", DOGLEGS)
@pytest.mark.parametrize("step", ["ITERATIVE_SCHUR", "CGNR"])
def test_iterative_tier_dogleg_matches_jax(step, dogleg):
    """The host minimizer over the iterative steps, built as the JAX
    classes allow: the Gauss-Newton point by PCG at the dogleg's mu D^2;
    rows to REL, the answer within 1e-6 relative (1e-8 absolute)."""
    jprog = JaxProgram(_problem(ct, _bal()), sort_rows=True)
    jopts = _opts(ct, step, dogleg)
    e = jordering.eligible_e_sets(jprog) if step == "ITERATIVE_SCHUR" else None
    ref = ct.Summary()
    jm = JaxMinimizer(jprog, JaxBlockKernels(jprog, jopts, step, e_families=e), jopts, ref)
    jm.minimize(jprog.initial_state())

    prog = CompiledProgram(_problem(ctt, _bal()), device="cpu")
    opts = _opts(ctt, step, dogleg)
    e = ordering.eligible_e_sets(prog) if step == "ITERATIVE_SCHUR" else None
    s = ctt.Summary()
    m = TrustRegionMinimizer(prog, BlockTrustRegionKernels(prog, opts, step, e_families=e),
                             opts, s)
    x = m.minimize(prog.initial_state())
    _assert_rows_match(s, ref, REL[step])
    assert m.x_cost == pytest.approx(jm.x_cost, rel=REL[step])
    np.testing.assert_allclose(x.numpy(), np.asarray(jm.x), rtol=1e-6, atol=1e-8)
