"""Inner iterations in the port against the JAX package on the CPU: the
coordinate descent (solvers/coordinate_descent.py) on one BA iterate, the
block colouring of a pose graph (utils/ordering.color_family_blocks) and
its independent sets, and use_inner_iterations in both LM loops, row by
row, each loop against the JAX loop of its kind. Twins of
tests/test_fused_lm.py:333-360 and tests/test_pose_graph.py:94-141, and
the Summary's inner-iteration fields. Each tolerance is stated where it
is used."""
import copy

import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu.models import bal as jbal
from ceres_tpu.models import pose_graph as jpg
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers.coordinate_descent import CoordinateDescentMinimizer as JaxCD
from ceres_tpu.utils import ordering as jord

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.models import pose_graph as tpg
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.solvers.coordinate_descent import CoordinateDescentMinimizer
from ceres_tpu_torch.utils import ordering as tord
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def make_ba(pkg, seed=3, noise=0.1):
    """tests/test_fused_lm.py's make_ba in either package."""
    b = jbal.perturb(jbal.synthetic_bal(num_cameras=6, num_points=60, visibility=0.5,
                                        noise=noise, seed=seed), 0.01, 0.05, 0.05)
    arrays = (b.cameras.copy(), b.points.copy(), b.camera_index.copy(),
              b.point_index.copy(), b.observations.copy())
    if pkg is ct:
        return jbal.build_problem_batched(jbal.BALProblem(*arrays))[0]
    return tbal.build_problem_batched(tbal.from_arrays(*arrays))[0]


def _solve(pkg, **kw):
    opts = dict(kw, linear_solver_type=pkg.LinearSolverType.DENSE_SCHUR)
    extra = {} if pkg is ct else dict(device="cpu")
    return pkg.solve(pkg.Options(**opts), make_ba(pkg), **extra)


def _rows(s):
    return np.array([r.cost for r in s.iterations])


@pytest.mark.parametrize("mode", ["NEVER", "ALWAYS"])
def test_inner_iterations_converge(mode):
    """DENSE_SCHUR with inner iterations, 12 iterations, in each loop
    against the JAX loop of its kind: every row within 1e-8 relative (the
    first step takes the cost from 3,640 to 0.7, which turns rounding at
    1e-13 of the start into 1e-9 of the row), the same number of rows;
    and the JAX test's own bound, at least the plain LM basin, within the
    port."""
    kw = dict(fused_loop=mode, max_num_iterations=12)
    sj = _solve(ct, use_inner_iterations=True, **kw)
    st = _solve(ctt, use_inner_iterations=True, **kw)
    plain = _solve(ctt, **kw)
    assert st.is_solution_usable() and st.inner_iterations_used
    assert len(st.iterations) == len(sj.iterations)
    np.testing.assert_allclose(_rows(st), _rows(sj), rtol=1e-8)
    assert st.final_cost <= plain.final_cost * (1 + 1e-6)


def test_inner_iterations_fused_matches_host():
    """The port's fused and host loops with inner iterations: each within
    1e-8 of the JAX loop of its kind in the final cost, and within the JAX
    test's 1e-2 of each other."""
    kw = dict(use_inner_iterations=True, max_num_iterations=12)
    out = {}
    for mode in ("NEVER", "ALWAYS"):
        sj = _solve(ct, fused_loop=mode, **kw)
        st = _solve(ctt, fused_loop=mode, **kw)
        assert st.final_cost == pytest.approx(sj.final_cost, rel=1e-8)
        out[mode] = st
    assert out["ALWAYS"].final_cost == pytest.approx(out["NEVER"].final_cost, rel=1e-2,
                                                     abs=1e-8)


def _pose2d(pkg, n=40, lc=6, noise=0.1, seed=3):
    pg = jpg if pkg is ct else tpg
    poses, cons, _ = pg.synthetic_2d(num_poses=n, loop_closures=lc, noise=noise, seed=seed)
    return pg.build_problem_2d(poses, cons)[0]


def _pose3d(pkg, n=30, lc=5, seed=2):
    pg = jpg if pkg is ct else tpg
    poses, cons, _ = pg.synthetic_3d(num_poses=n, loop_closures=lc, seed=seed)
    return pg.build_problem_3d(copy.deepcopy(poses), cons)[0]


@pytest.mark.parametrize("graph", ["2d", "3d"])
def test_color_family_blocks_matches_jax(graph):
    """The colouring of every family of a pose graph bit for bit, and the
    coordinate descent's independent sets in the same order."""
    make = _pose2d if graph == "2d" else _pose3d
    jprog = JaxProgram(make(ct), sort_rows=True)
    tprog = CompiledProgram(make(ctt), sort_rows=True, device="cpu")
    assert len(jprog.families) == len(tprog.families)
    for fi in range(len(tprog.families)):
        cj, nj = jord.color_family_blocks(jprog, fi)
        c_t, n_t = tord.color_family_blocks(tprog, fi)
        assert n_t == nj
        np.testing.assert_array_equal(c_t, cj)
    js, ts = JaxCD(jprog, ct.Options()).sets, CoordinateDescentMinimizer(tprog, ctt.Options()).sets
    assert [fi for fi, _ in ts] == [fi for fi, _ in js]
    for (_, mt), (_, mj) in zip(ts, js):
        assert (mt is None) == (mj is None)
        if mt is not None:
            np.testing.assert_array_equal(mt, mj)


def test_inner_iterations_pose_graph_block_coloring():
    """tests/test_pose_graph.py:94-141 in the port: a 2D pose graph's one
    pose family decomposes by colouring into at least two independent
    sets, each truly independent; the host loop's inner iterations run and
    reach at least the plain run's cost; and the run's rows within 1e-9 of
    the JAX host loop's."""
    prog = CompiledProgram(_pose2d(ctt), device="cpu")
    cdm = CoordinateDescentMinimizer(prog, ctt.Options())
    assert len(cdm.sets) >= 2
    assert any(mask is not None for _, mask in cdm.sets)
    for fi, mask in cdm.sets:
        if mask is None:
            continue
        fam = prog.families[fi]
        for kind in prog.kinds:
            ours = [s for s in kind.slots if s.family is fam and s.any_variable]
            for a in range(len(ours)):
                for b in range(a + 1, len(ours)):
                    pa, pb = ours[a].pos_in_family, ours[b].pos_in_family
                    keep = (pa < fam.num_var) & (pb < fam.num_var) & (pa != pb)
                    assert not np.any(mask[pa[keep]] & mask[pb[keep]])

    def run(pkg, inner):
        extra = {} if pkg is ct else dict(device="cpu")
        return pkg.solve(pkg.Options(max_num_iterations=4, fused_loop="NEVER",
                                     use_inner_iterations=inner), _pose2d(pkg), **extra)

    s_plain, s_inner, sj = run(ctt, False), run(ctt, True), run(ct, True)
    assert s_inner.num_inner_iteration_steps >= 1
    assert s_inner.inner_iterations_used
    assert s_inner.final_cost <= s_plain.final_cost * (1 + 1e-6)
    assert len(s_inner.iterations) == len(sj.iterations)
    np.testing.assert_allclose(_rows(s_inner), _rows(sj), rtol=1e-9)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_coordinate_descent_minimize_matches_jax(dtype):
    """One CoordinateDescentMinimizer.minimize on a BA iterate (both sets,
    points then cameras, three LM steps each). float64: the state within
    1e-12 of the JAX one relative to its largest entry. float32: a block
    whose step changes its cost by an ulp may be accepted in one package
    and refused in the other, so the cost at the sweep's state is held,
    within 1e-4 relative of the JAX one's (the sweep takes it from 3,640
    to 436; the two differ by 2e-5 here), each below the start's."""
    jprog = JaxProgram(make_ba(ct), compute_dtype=dtype, sort_rows=True)
    tprog = CompiledProgram(make_ba(ctt), dtype, device="cpu")
    x0 = np.asarray(jprog.initial_state())
    np.testing.assert_array_equal(tprog.initial_state().numpy(), x0)
    xj = np.asarray(JaxCD(jprog, ct.Options()).minimize(jprog.initial_state()))
    xt = CoordinateDescentMinimizer(tprog, ctt.Options()).minimize(tprog.initial_state())
    assert np.abs(xj - x0).max() > 1e-6  # the sweep moved the state
    if dtype == "float64":
        np.testing.assert_allclose(xt.numpy(), xj, rtol=0, atol=1e-12 * np.abs(xj).max())
    else:
        f64 = CompiledProgram(make_ba(ctt), device="cpu")
        c0 = float(f64.evaluate_cost(torch.as_tensor(x0)))
        cj = float(f64.evaluate_cost(torch.as_tensor(xj)))
        assert float(f64.evaluate_cost(xt)) == pytest.approx(cj, rel=1e-4)
        assert cj < 0.5 * c0


def test_summary_inner_iteration_fields_match_jax():
    """The seven fields the Summary gained, field by field after a host-loop
    inner-iteration solve: the counts and flags equal, the inner time
    positive in both, the residual evaluation time zero in both (set by
    nothing). On the fused loop the port also reports the flags, which
    the JAX package leaves False there, and counts its inner steps."""
    kw = dict(use_inner_iterations=True, max_num_iterations=8, fused_loop="NEVER")
    sj, st = _solve(ct, **kw), _solve(ctt, **kw)
    for name in ("num_inner_iteration_steps", "num_line_search_steps",
                 "num_gradient_evaluations", "inner_iterations_given",
                 "inner_iterations_used", "residual_evaluation_time_in_seconds"):
        assert getattr(st, name) == getattr(sj, name), name
    assert st.num_inner_iteration_steps >= 1
    assert st.inner_iteration_time_in_seconds > 0 and sj.inner_iteration_time_in_seconds > 0
    fused = _solve(ctt, use_inner_iterations=True, max_num_iterations=8, fused_loop="ALWAYS")
    assert fused.inner_iterations_given and fused.inner_iterations_used
    assert 1 <= fused.num_inner_iteration_steps <= len(fused.iterations) - 1
