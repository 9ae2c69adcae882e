"""The port's line-search minimizers against the JAX package's on the CPU:
the host loop (solvers/line_search.py) against the JAX host loop, the
fused loop (solvers/fused_line_search.py) against the JAX fused loop,
never across (the two differ by design). Twins of
tests/test_fused_line_search.py, the NLLS curve fit through ctt.solve, a
small bundle adjustment in both dtypes, LINE_SEARCH with bounds,
LowRankInverseHessian and the interpolation half of utils/polynomial.py
function by function, and the Summary's line-search fields. Each
tolerance is stated where it is used.

Rosenbrock amplifies rounding: the two packages' costs differ by an ulp
at the start (XLA and torch round the function differently) and chaotic
configurations (steepest descent, nonlinear CG) part after a dozen rows,
as the JAX file's own host-against-fused test says. Those hold their first
ROSEN_ROWS rows within 1e-6 relative; the converging ones (LBFGS, BFGS)
also their answers within 1e-9."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu.gradient_problem import GradientProblem as JaxGradientProblem
from ceres_tpu.gradient_problem import solve_gradient_problem as jax_solve_gp
from ceres_tpu.models import bal as jbal
from ceres_tpu.solvers import line_search as jls
from ceres_tpu.utils import polynomial as jpoly

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.solvers import line_search as tls
from ceres_tpu_torch.utils import polynomial as tpoly
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROSEN_ROWS = 6


def rosenbrock(x):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] * x[0]) ** 2


def _opts(pkg, **kw):
    """pkg.Options with enum fields named by string."""
    enums = {"line_search_direction_type": pkg.LineSearchDirectionType,
             "line_search_type": pkg.LineSearchType,
             "nonlinear_conjugate_gradient_type": pkg.NonlinearConjugateGradientType,
             "line_search_interpolation_type": pkg.LineSearchInterpolationType}
    kw = {k: enums[k][v] if k in enums else v for k, v in kw.items()}
    return pkg.Options(minimizer_type=pkg.MinimizerType.LINE_SEARCH, **kw)


def _gp_pair(fused, fn=rosenbrock, x0=(-1.2, 1.0), n=2, **kw):
    """(JAX summary, port summary, JAX x, port x) of one configuration."""
    base = dict(max_num_iterations=300, fused_loop=fused)
    base.update(kw)
    xj, xt = np.asarray(x0, np.float64), np.asarray(x0, np.float64)
    sj = jax_solve_gp(_opts(ct, **base), JaxGradientProblem(fn, n), xj)
    st = ctt.solve_gradient_problem(_opts(ctt, **base), ctt.GradientProblem(fn, n), xt,
                                    device="cpu")
    return sj, st, xj, xt


def _rows(s):
    return np.array([r.cost for r in s.iterations])


def _first_rows_agree(sj, st, n=ROSEN_ROWS, rtol=1e-6):
    assert len(st.iterations) >= min(n, len(sj.iterations))
    np.testing.assert_allclose(_rows(st)[:n], _rows(sj)[:n], rtol=rtol, atol=1e-14)


@pytest.mark.parametrize("direction", ["LBFGS", "BFGS", "NONLINEAR_CONJUGATE_GRADIENT",
                                       "STEEPEST_DESCENT"])
@pytest.mark.parametrize("search", ["WOLFE", "ARMIJO"])
def test_fused_matches_host_rosenbrock(direction, search):
    """Each configuration in both loops against the JAX loop of its kind:
    the first rows within 1e-6, the same termination; LBFGS and BFGS with
    WOLFE to the JAX answer within 1e-9 (and below 1e-10 in cost); the
    rest the JAX test's progress (a fifth of the start's cost)."""
    kw = dict(line_search_direction_type=direction, line_search_type=search)
    if direction in ("BFGS", "LBFGS") and search == "ARMIJO":
        ok_j, msg_j = _opts(ct, **kw).is_valid()
        assert _opts(ctt, **kw).is_valid() == (ok_j, msg_j) and not ok_j
        return
    for fused in ("NEVER", "ALWAYS"):
        sj, st, xj, xt = _gp_pair(fused, **kw)
        _first_rows_agree(sj, st)
        if direction in ("STEEPEST_DESCENT",) or search == "ARMIJO":
            assert st.final_cost < st.iterations[0].cost * 0.2
            continue
        assert st.termination_type.name == sj.termination_type.name
        if direction in ("LBFGS", "BFGS"):
            assert st.final_cost < 1e-10 and sj.final_cost < 1e-10
            np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-9)


@pytest.mark.parametrize("ncg", ["FLETCHER_REEVES", "POLAK_RIBIERE", "HESTENES_STIEFEL"])
def test_fused_ncg_variants(ncg):
    """Each beta in both loops against the JAX loop of its kind: the first
    rows within 1e-6 and the same termination; the JAX test's
    fused-against-host bound (half the cost) within the port."""
    kw = dict(line_search_direction_type="NONLINEAR_CONJUGATE_GRADIENT",
              nonlinear_conjugate_gradient_type=ncg)
    out = {}
    for fused in ("NEVER", "ALWAYS"):
        sj, st, _, _ = _gp_pair(fused, **kw)
        _first_rows_agree(sj, st)
        assert st.termination_type.name == sj.termination_type.name
        out[fused] = st
    assert out["ALWAYS"].termination_type == out["NEVER"].termination_type
    assert out["ALWAYS"].final_cost == pytest.approx(out["NEVER"].final_cost, rel=0.5,
                                                     abs=1e-8)


def test_fused_interpolation_types():
    """The fused loop with each interpolation against the JAX fused loop:
    the first rows within 1e-6, below 1e-8 in cost as the JAX test holds
    its own, and the same termination."""
    for interp in ("BISECTION", "QUADRATIC", "CUBIC"):
        sj, st, _, _ = _gp_pair("ALWAYS", line_search_interpolation_type=interp)
        _first_rows_agree(sj, st)
        assert st.final_cost < 1e-8, interp
        assert st.termination_type.name == sj.termination_type.name


def _curve_fit(pkg, fused, dtype="float64"):
    rng = np.random.default_rng(0)
    xs = np.linspace(0, 3, 40)
    ys = np.exp(0.3 * xs + 0.1) + 0.001 * rng.standard_normal(40)
    xp = jnp if pkg is ct else torch

    def f(mc, data):
        x, y = data
        return y - xp.exp(mc[0] * x + mc[1])

    cost = pkg.AutoDiffCostFunction(f, 1, [2])
    mc = np.array([0.0, 0.0])
    p = pkg.Problem()
    for x, y in zip(xs, ys):
        p.add_residual_block(cost, None, [mc], data=(np.float64(x), np.float64(y)))
    extra = {} if pkg is ct else dict(device="cpu")
    s = pkg.solve(_opts(pkg, fused_loop=fused, max_num_iterations=200,
                        evaluation_dtype=dtype), p, **extra)
    return s, mc


@pytest.mark.parametrize("fused", ["NEVER", "ALWAYS"])
def test_fused_line_search_nlls_problem(fused):
    """The exponential curve fit through ctt.solve in each loop against the
    JAX loop of its kind: the same rows, each within 1e-9, and the fit
    within 1e-9; the JAX test's fused-against-host bound within the port."""
    sj, mj = _curve_fit(ct, fused)
    st, mt = _curve_fit(ctt, fused)
    assert st.is_solution_usable()
    assert len(st.iterations) == len(sj.iterations)
    np.testing.assert_allclose(_rows(st), _rows(sj), rtol=1e-9)
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-9)
    assert st.final_cost == pytest.approx(sj.final_cost, rel=1e-9)
    if fused == "ALWAYS":
        host, _ = _curve_fit(ctt, "NEVER")
        assert st.final_cost == pytest.approx(host.final_cost, rel=1e-4, abs=1e-12)


@pytest.mark.parametrize("fused", ["NEVER", "ALWAYS"])
def test_fused_gradient_problem_with_manifold(fused):
    """The quaternion fit of the JAX test in each loop: the same rows and
    the same unit quaternion, within 1e-12."""
    from ceres_tpu import rotation as jrot

    from ceres_tpu_torch import rotation as trot

    def cost_j(q):
        v = jrot.unit_quaternion_rotate_point(q, jnp.asarray([1.0, 0.0, 0.0]))
        return jnp.sum((v - jnp.asarray([0.0, 0.0, 1.0])) ** 2)

    def cost_t(q):
        v = trot.unit_quaternion_rotate_point(q, torch.tensor([1.0, 0.0, 0.0],
                                                              dtype=torch.float64))
        return torch.sum((v - torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64)) ** 2)

    qj, qt = np.asarray([1.0, 0.0, 0.0, 0.0]), np.asarray([1.0, 0.0, 0.0, 0.0])
    o = dict(fused_loop=fused, max_num_iterations=200)
    sj = jax_solve_gp(_opts(ct, **o), JaxGradientProblem(cost_j, 4, manifold=ct.QuaternionManifold()), qj)
    st = ctt.solve_gradient_problem(
        _opts(ctt, **o), ctt.GradientProblem(cost_t, 4, manifold=ctt.QuaternionManifold()),
        qt, device="cpu")
    assert st.final_cost < 1e-12
    np.testing.assert_allclose(np.linalg.norm(qt), 1.0, atol=1e-9)
    np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(_rows(st), _rows(sj), rtol=1e-12, atol=1e-20)


def test_fused_max_iterations():
    """Three iterations in the fused loop: four rows within 1e-9 of the JAX
    fused loop's, NO_CONVERGENCE with the same message."""
    sj, st, _, _ = _gp_pair("ALWAYS", max_num_iterations=3)
    assert len(st.iterations) == len(sj.iterations) == 4
    np.testing.assert_allclose(_rows(st), _rows(sj), rtol=1e-9)
    assert st.termination_type.name == sj.termination_type.name == "NO_CONVERGENCE"
    assert st.message == sj.message


def test_fused_termination_messages():
    """The default fused Rosenbrock solve converges with the JAX fused
    loop's termination and message (its tolerance in it)."""
    sj, st, _, _ = _gp_pair("ALWAYS")
    assert st.termination_type.name == sj.termination_type.name == "CONVERGENCE"
    assert st.message == sj.message


@pytest.mark.parametrize("interp", ["CUBIC", "QUADRATIC", "BISECTION"])
def test_armijo_three_point_interpolation_parity(interp):
    """NCG with ARMIJO on a smooth convex quartic, 25 iterations, each loop
    against the JAX loop of its kind: every row within 1e-7 relative (the
    JAX test holds its host and fused loops to 1e-6 over 12 rows; the
    quartic's flat minimum turns the packages' one-ulp differences in the
    function into a few 1e-9 by the last rows)."""
    def cost(v):
        x, y = v[0], v[1]
        return (x - 1.0) ** 4 + 10.0 * (y + 2.0) ** 4 + 0.5 * x * x + y * y

    kw = dict(line_search_direction_type="NONLINEAR_CONJUGATE_GRADIENT",
              line_search_type="ARMIJO", line_search_interpolation_type=interp,
              max_num_iterations=25)
    for fused in ("NEVER", "ALWAYS"):
        sj, st, _, _ = _gp_pair(fused, fn=cost, x0=(4.0, 3.0), **kw)
        assert len(st.iterations) == len(sj.iterations)
        np.testing.assert_allclose(_rows(st), _rows(sj), rtol=1e-7, atol=1e-15)


def _ba(pkg, b):
    arrays = (b.cameras.copy(), b.points.copy(), b.camera_index.copy(),
              b.point_index.copy(), b.observations.copy())
    if pkg is ct:
        return jbal.build_problem_batched(jbal.BALProblem(*arrays))[0]
    return tbal.build_problem_batched(tbal.from_arrays(*arrays))[0]


@pytest.mark.parametrize("fused", ["NEVER", "ALWAYS"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_bundle_adjustment_rows_match_jax(fused, dtype):
    """LBFGS + WOLFE on a 4-camera BAL problem, each loop against the JAX
    loop of its kind: float64 every row of 30 iterations within 1e-8
    relative; float32 the first 8 rows within 1e-5 (the two packages'
    float32 evaluations round differently, and LBFGS amplifies that about
    twofold a row); the same probe count in float64."""
    b = jbal.perturb(jbal.synthetic_bal(num_cameras=4, num_points=300, visibility=0.5,
                                        seed=0), 0.01, 0.05, 0.05, seed=1)
    o = dict(fused_loop=fused, evaluation_dtype=dtype, max_num_iterations=30)
    sj = ct.solve(_opts(ct, **o), _ba(ct, b))
    st = ctt.solve(_opts(ctt, **o), _ba(ctt, b), device="cpu")
    if dtype == "float64":
        assert len(st.iterations) == len(sj.iterations)
        np.testing.assert_allclose(_rows(st), _rows(sj), rtol=1e-8)
        assert st.num_line_search_steps == sj.num_line_search_steps
    else:
        np.testing.assert_allclose(_rows(st)[:8], _rows(sj)[:8], rtol=1e-5)


def test_summary_line_search_fields_match_jax():
    """The seven fields the Summary gained, field by field after a line-
    search solve in each loop: the counts equal, the flags equal, the
    times zero where the JAX package sets none. Host syncs: at most one per
    probe plus one per iteration, and one before the first."""
    b = jbal.perturb(jbal.synthetic_bal(num_cameras=4, num_points=100, visibility=0.5,
                                        seed=2), 0.01, 0.05, 0.05, seed=1)
    for fused in ("NEVER", "ALWAYS"):
        o = dict(fused_loop=fused, max_num_iterations=10)
        sj = ct.solve(_opts(ct, **o), _ba(ct, b))
        st = ctt.solve(_opts(ctt, **o), _ba(ctt, b), device="cpu")
        for name in ("num_inner_iteration_steps", "num_line_search_steps",
                     "num_gradient_evaluations", "inner_iterations_given",
                     "inner_iterations_used", "residual_evaluation_time_in_seconds",
                     "inner_iteration_time_in_seconds", "num_residual_evaluations"):
            assert getattr(st, name) == getattr(sj, name), (fused, name)
        n_it = len(st.iterations) - 1
        assert st.num_host_syncs <= st.num_line_search_steps + n_it + 1


def test_line_search_with_bounds_fails_as_in_jax():
    """A bounded problem under LINE_SEARCH: FAILURE with the JAX message,
    the parameters untouched."""
    out = []
    for pkg in (ct, ctt):
        x = np.array([3.0, -1.0])
        p = pkg.Problem()
        xp = jnp if pkg is ct else torch
        p.add_residual_block(pkg.AutoDiffCostFunction(lambda v: v - xp.asarray(1.0), 2, [2]),
                             None, [x])
        p.set_parameter_lower_bound(x, 0, 2.0)
        extra = {} if pkg is ct else dict(device="cpu")
        out.append((pkg.solve(_opts(pkg), p, **extra), x))
    (sj, xj), (st, xt) = out
    assert st.termination_type.name == sj.termination_type.name == "FAILURE"
    assert st.message == sj.message == "LINE_SEARCH Minimizer does not support bounds."
    np.testing.assert_array_equal(xt, [3.0, -1.0])


@pytest.mark.parametrize("use_approx", [False, True])
def test_low_rank_inverse_hessian_matches_jax(use_approx):
    """LowRankInverseHessian against the JAX class, method by method: each
    pair pushed as the minimizer pushes it, after the minimizer's own s'y >
    1e-10 test, which accepts and refuses the pairs the JAX update does; the
    same scale, and right_multiply within 1e-13 relative, through a full history (rank 3,
    six pairs) and with none."""
    rng = np.random.default_rng(4)
    T = 12
    jh = jls.LowRankInverseHessian(3, use_approx)
    th = tls.LowRankInverseHessian(3, use_approx)
    g = rng.standard_normal(T)
    for h, arr in ((jh, g), (th, torch.as_tensor(g))):
        assert h.right_multiply(arr) is not None
    np.testing.assert_allclose(th.right_multiply(torch.as_tensor(g)).numpy(),
                               jh.right_multiply(g.copy()), rtol=1e-13)
    for i in range(7):
        s = rng.standard_normal(T)
        y = s + 0.3 * rng.standard_normal(T) if i != 3 else -s  # i = 3: s'y < 0
        # the minimizer's path: it makes the pair test and pushes the pair
        sy, yy = float(s @ y), float(y @ y)
        if sy > tls._SY_MIN:
            th.push(torch.as_tensor(s), torch.as_tensor(y), sy, yy)
        assert (sy > tls._SY_MIN) == jh.update(s, y)
        assert th.approx_eigenvalue_scale == pytest.approx(jh.approx_eigenvalue_scale,
                                                           rel=1e-14)
        assert len(th.s) == len(jh.s)
        g = rng.standard_normal(T)
        np.testing.assert_allclose(th.right_multiply(torch.as_tensor(g)).numpy(),
                                   jh.right_multiply(g.copy()), rtol=1e-13, atol=1e-14)


def test_polynomial_interpolation_matches_jax():
    """find_interpolating_polynomial, minimize_polynomial and
    minimize_interpolating_polynomial against the JAX functions on random
    sample sets of two and three samples, values with and without
    gradients: coefficients within 1e-10 relative, minima within 1e-12."""
    rng = np.random.default_rng(5)
    for trial in range(40):
        n = 2 + trial % 2
        xs = np.sort(rng.uniform(0.0, 2.0, n))
        tj, tt = [], []
        for i, x in enumerate(xs):
            v, g = rng.standard_normal(), rng.standard_normal()
            with_g = i == 0 or trial % 3 == 0
            tj.append(jpoly.FunctionSample.with_gradient(x, v, g) if with_g
                      else jpoly.FunctionSample.value_only(x, v))
            tt.append(tpoly.FunctionSample.with_gradient(x, v, g) if with_g
                      else tpoly.FunctionSample.value_only(x, v))
        cj = jpoly.find_interpolating_polynomial(tj)
        ct_ = tpoly.find_interpolating_polynomial(tt)
        np.testing.assert_allclose(ct_, cj, rtol=1e-10, atol=1e-12)
        lo, hi = xs[0], xs[-1] + 0.5
        assert tpoly.minimize_polynomial(ct_, lo, hi) == pytest.approx(
            jpoly.minimize_polynomial(cj, lo, hi), rel=1e-12, abs=1e-12)
        assert tpoly.minimize_interpolating_polynomial(tt, lo, hi) == pytest.approx(
            jpoly.minimize_interpolating_polynomial(tj, lo, hi), rel=1e-12, abs=1e-12)
        assert tpoly.evaluate_polynomial(ct_, 0.7) == pytest.approx(
            jpoly.evaluate_polynomial(cj, 0.7), rel=1e-12, abs=1e-12)
