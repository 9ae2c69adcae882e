"""DOGLEG in the port's fused loop (solvers/fused_lm.DoglegStepOps),
TRADITIONAL and SUBSPACE, over DENSE_QR, DENSE_NORMAL_CHOLESKY and
DENSE_SCHUR, against ceres_tpu's fused loop (DoglegOpsWrapper) on the same
problems, on the CPU: the whole solve row for row, the subspace boundary
minimizer on the same inputs, and the escalation of mu while the
Gauss-Newton point is not finite. float64; each JAX solve passes
fused_loop="ALWAYS". Each tolerance is stated where it is used."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu.solvers import fused_lm as jfused

import ceres_tpu_torch as ctt
from ceres_tpu_torch.ops import kernels as kn
from ceres_tpu_torch.solvers import fused_lm as tfused
from test_torch_dense_step import assert_rows_match, ba, jax_ba, port_ba

# a start radius of 1 makes the dogleg path bind for the first rows (from
# the default 1e4 every step is the Gauss-Newton point, and the two
# strategies are one)
RADIUS = 1.0


def _opts(pkg, lst, dogleg, **kw):
    return pkg.Options(linear_solver_type=pkg.LinearSolverType[lst],
                       trust_region_strategy_type=pkg.TrustRegionStrategyType.DOGLEG,
                       dogleg_type=pkg.DoglegType[dogleg],
                       initial_trust_region_radius=RADIUS, **kw)


def _pair(lst, dogleg):
    b = ba()
    ref = ct.solve(_opts(ct, lst, dogleg, fused_loop="ALWAYS"), jax_ba(b))
    kn.reset_counts()
    s = ctt.solve(_opts(ctt, lst, dogleg, fused_loop="ALWAYS"), port_ba(b), device="cpu")
    return ref, s, {k.__name__: k.plain_calls for k in kn.KERNELS}


CASES = [("DENSE_QR", "TRADITIONAL_DOGLEG"), ("DENSE_QR", "SUBSPACE_DOGLEG"),
         ("DENSE_SCHUR", "TRADITIONAL_DOGLEG"), ("DENSE_SCHUR", "SUBSPACE_DOGLEG"),
         ("DENSE_NORMAL_CHOLESKY", "SUBSPACE_DOGLEG")]


@pytest.fixture(scope="module")
def solved():
    return {case: _pair(*case) for case in CASES}


@pytest.mark.parametrize("lst,dogleg", CASES)
def test_dogleg_matches_jax_row_for_row(solved, lst, dogleg):
    """On the 6-camera, 60-point BA problem from radius 1: the same
    termination and rows; each row's cost and radius to 1e-9 relative
    (the theta-grid argmin of SUBSPACE makes no row looser here)."""
    ref, out, _ = solved[(lst, dogleg)]
    assert out.termination_type.name == ref.termination_type.name == "CONVERGENCE"
    assert_rows_match(out, ref)
    assert out.trust_region_strategy_type == ctt.TrustRegionStrategyType.DOGLEG
    # the dogleg radius rules ran: the radius tripled after the first steps
    assert [r.trust_region_radius for r in out.iterations[:3]] == [1.0, 3.0, 9.0]


def test_subspace_takes_another_path_than_traditional(solved):
    """The subspace minimizer is in the path: its trajectory parts from the
    traditional one's (the sixth row's radius is 153.57 against 167.47 in
    both packages)."""
    trad = solved[("DENSE_QR", "TRADITIONAL_DOGLEG")][1]
    sub = solved[("DENSE_QR", "SUBSPACE_DOGLEG")][1]
    assert sub.iterations[5].trust_region_radius != pytest.approx(
        trad.iterations[5].trust_region_radius, rel=1e-3)


@pytest.mark.parametrize("dogleg", ["TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG"])
def test_dogleg_on_dense_schur_takes_the_flat_path(solved, dogleg):
    """DOGLEG leaves the jt path (fused_lm.py:294-298): a BAL program runs
    the flat dense-Schur step's kernels (the spread sum, the segment sums,
    the gather), never eval_fused or schur_assembly. The host syncs once
    per LM iteration, once before the first and once per test of the
    Gauss-Newton point (one a row here: no escalation)."""
    _, out, plain = solved[("DENSE_SCHUR", dogleg)]
    n_it = len(out.iterations) - 1
    assert out.num_host_syncs == 2 * n_it + 1
    for name in ("segment_spread_sum", "segment_block_sum", "unsorted_segment_sum",
                 "segment_block_expand"):
        assert plain[name] >= n_it, name
    for name in ("eval_fused", "post_eval_fused", "schur_assembly", "normal_matvec"):
        assert plain[name] == 0, name


def _wrappers(J):
    """The port's and the JAX package's dogleg over a dense step, without a
    program: the boundary minimizer reads only J through _jv."""
    t_in = tfused.DenseStepOps.__new__(tfused.DenseStepOps)
    t_in.program = None
    j_in = jfused.DenseStepOps.__new__(jfused.DenseStepOps)
    j_in.program = None
    return (tfused.DoglegStepOps(t_in, subspace=True),
            tfused.DenseForm(torch.as_tensor(J), None),
            jfused.DoglegOpsWrapper(j_in, subspace=True), (jnp.asarray(J),))


@pytest.mark.parametrize("radius", [0.05, 0.3, 1.0, 4.0])
def test_subspace_step_matches_jax(radius):
    """The boundary minimizer of the 2-D model on |x| = radius (the
    theta-grid argmin, five Newton steps, the optimality test) on the same
    seeded J, gradient and Gauss-Newton point: the step to 1e-12 relative,
    the same verdict."""
    rng = np.random.default_rng(int(radius * 100))
    J = rng.standard_normal((12, 5))
    D = rng.uniform(0.5, 2.0, 5)
    es = rng.uniform(0.5, 1.5, 5)
    g_s = rng.standard_normal(5)
    gn_s = 3.0 * rng.standard_normal(5)
    tw, tv, jw, jv = _wrappers(J)
    step, ok = tw._subspace_step(tv, torch.as_tensor(es), torch.as_tensor(D),
                                 torch.as_tensor(g_s), torch.as_tensor(gn_s), radius)
    step_ref, ok_ref = jw._subspace_step(jv, jnp.asarray(es), jnp.asarray(D),
                                         jnp.asarray(g_s), jnp.asarray(gn_s), radius)
    assert bool(ok) == bool(ok_ref)
    ref = np.asarray(step_ref)
    assert np.abs(step.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    assert np.linalg.norm(step.numpy()) == pytest.approx(radius, rel=1e-12)


def test_mu_escalates_while_the_gauss_newton_point_is_not_finite(monkeypatch):
    """With the dense step made to fail (NaN) while mu * diag has an entry
    below 1e-7, both packages escalate mu tenfold per failed solve and
    carry it over the rows by the dogleg rules: the same rows (cost and
    radius to 1e-9 relative). The port tests each Gauss-Newton point at
    one host sync: more syncs than one per row."""
    def failing(orig, np_, d2_arg):
        """compute_step with its D2_c argument at position d2_arg (the JAX
        signature carries r before the scales)."""
        def compute_step(self, *args):
            step, mcc, it = orig(self, *args)
            return step * np_.where(args[d2_arg].min() < 1e-7, np_.nan, 1.0), mcc, it
        return compute_step

    monkeypatch.setattr(jfused.DenseStepOps, "compute_step",
                        failing(jfused.DenseStepOps.compute_step, jnp, 5))

    class _T:
        nan = float("nan")

        @staticmethod
        def where(c, a, b):
            return torch.where(c, torch.tensor(a, dtype=torch.float64),
                               torch.tensor(b, dtype=torch.float64))

    monkeypatch.setattr(tfused.DenseStepOps, "compute_step",
                        failing(tfused.DenseStepOps.compute_step, _T, 4))
    ref, out, _ = _pair("DENSE_QR", "TRADITIONAL_DOGLEG")
    assert_rows_match(out, ref)
    n_it = len(out.iterations) - 1
    assert out.num_host_syncs > 2 * n_it + 1
