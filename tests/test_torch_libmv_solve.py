"""The flat Schur path's solves on the libmv bundle adjuster's model:
ceres_tpu_torch.solve on the CPU (the kernels' plain versions) against
ceres_tpu.solve (its fused loop) on the same problem, DENSE_SCHUR and
ITERATIVE_SCHUR in float64 and float32. Each tolerance is stated where
it is used."""
import pytest

from ceres_tpu.models import libmv as jlibmv

import chip_smoke
from ceres_tpu_torch.models import libmv as tlibmv
from test_torch_libmv import _jax_solve, _port_solve, jax_lp, small_libmv


@pytest.fixture(scope="module")
def solved():
    lp = small_libmv()
    out = {}
    for lst in ("DENSE_SCHUR", "ITERATIVE_SCHUR"):
        for dtype in ("float64", "float32"):
            ref = _jax_solve(jlibmv.build_problem(jax_lp(lp))[0], lst, dtype)
            s, counts = _port_solve(tlibmv.build_problem(chip_smoke.fresh(lp))[0], lst,
                                    dtype)
            out[(lst, dtype)] = (ref, s, counts)
    return out


@pytest.mark.parametrize("lst", ["DENSE_SCHUR", "ITERATIVE_SCHUR"])
def test_libmv_solve_matches_jax_row_for_row(solved, lst):
    """float64: the same termination, rows and CG counts; each row's cost
    to 1e-9 relative, and with DENSE_SCHUR its radius too. With
    ITERATIVE_SCHUR the radius follows the model cost change of a CG of
    about 20 iterations, whose rounding (the two packages sum in other
    orders) moves it by up to ~3e-8 while the costs agree to 1e-9."""
    ref, out, _ = solved[(lst, "float64")]
    assert out.termination_type.name == ref.termination_type.name == "CONVERGENCE"
    assert len(out.iterations) == len(ref.iterations)
    assert ([r.linear_solver_iterations for r in out.iterations]
            == [r.linear_solver_iterations for r in ref.iterations])
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9)
        if lst == "DENSE_SCHUR":
            assert c.trust_region_radius == pytest.approx(a.trust_region_radius,
                                                          rel=1e-9)
    assert out.schur_structure_used == "2,3,d"


@pytest.mark.parametrize("lst", ["DENSE_SCHUR", "ITERATIVE_SCHUR"])
def test_libmv_float32_solve_reaches_the_jax_cost(solved, lst):
    """float32: the final cost within 1e-4 relative of the JAX package's
    float32 solve (the float32 trajectories part at the first step, from
    rounding in the reduced system)."""
    ref, out, _ = solved[(lst, "float32")]
    assert out.is_solution_usable()
    assert out.final_cost == pytest.approx(ref.final_cost, rel=1e-4)


@pytest.mark.parametrize("lst", ["DENSE_SCHUR", "ITERATIVE_SCHUR"])
def test_libmv_solve_runs_the_flat_kernels(solved, lst):
    """On the CPU the flat path runs the plain versions of its kernels, at
    least once per LM iteration each (the spread sum on the dense path
    only), and none of the jt path's."""
    _, out, counts = solved[(lst, "float64")]
    n_it = len(out.iterations) - 1
    assert all(launches == 0 for launches, _ in counts.values())
    flat = ["segment_block_sum", "segment_block_expand", "unsorted_segment_sum"]
    for name in flat:
        assert counts[name][1] >= n_it, name
    assert (counts["segment_spread_sum"][1] >= n_it) == (lst == "DENSE_SCHUR")
    for name in ("eval_fused", "post_eval_fused", "schur_assembly", "normal_matvec",
                 "isc_matvec", "schur_jacobi_blocks"):
        assert counts[name][1] == 0, name
