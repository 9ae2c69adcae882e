"""The modeling API of the port: ceres_tpu_torch.Problem's
per-block half, the compiled program's constant blocks and layout,
Problem.evaluate, the user ordering, and the solves that run through
them, each against its ceres_tpu counterpart on the same inputs.

Twins of tests/test_problem.py (all but the callback-mutation test and
the compiled-program cache tests: the port has no such cache),
tests/test_batched_problem.py (all but the sharded evaluation) and
tests/test_evaluator.py's layout tests; then the paths of the slice on
the CPU against the JAX fused loop: the gauge-fixed BA problem built one
block at a time (a constant camera: the row plan's sentinel on the jt
path), the libmv bundle adjuster with constant intrinsics (a constant
family on the flat path) and a user linear_solver_ordering. Each
tolerance is stated where it is used."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu.models import bal as jbal
from ceres_tpu.models import libmv as jlibmv
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.utils import ordering as jordering

import chip_smoke
import ceres_tpu_torch as ctt
from ceres_tpu_torch.cost_function import AutoDiffCostFunction, CostFunction
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.models import libmv as tlibmv
from ceres_tpu_torch.ops import bsr
from ceres_tpu_torch.ops import kernels as kn
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.utils import ordering as tordering
from test_torch_libmv import jax_lp, small_libmv

CPU = "cpu"


def quad_cost():
    return AutoDiffCostFunction(lambda x: x - 1.0, 2, [2])


# -------------------------------------------------- twins of test_problem.py


def test_add_residual_block_counts():
    p = ctt.Problem()
    x = np.zeros(2)
    rb = p.add_residual_block(quad_cost(), None, [x])
    assert p.num_parameter_blocks() == 1
    assert p.num_parameters() == 2
    assert p.num_residual_blocks() == 1
    assert p.num_residuals() == 2
    p.remove_residual_block(rb)
    assert p.num_residual_blocks() == 0
    assert p.num_parameter_blocks() == 1  # the block stays


def test_remove_parameter_block_removes_dependents():
    p = ctt.Problem()
    x, y = np.zeros(2), np.zeros(2)
    p.add_residual_block(AutoDiffCostFunction(lambda a, b: a - b, 2, [2, 2]), None, [x, y])
    p.add_residual_block(quad_cost(), None, [x])
    p.remove_parameter_block(y)
    assert p.num_residual_blocks() == 1
    assert p.num_parameter_blocks() == 1


def test_size_mismatch_raises():
    with pytest.raises(ValueError):
        ctt.Problem().add_residual_block(quad_cost(), None, [np.zeros(3)])


def test_duplicate_blocks_raise():
    x = np.zeros(2)
    with pytest.raises(ValueError):
        ctt.Problem().add_residual_block(
            AutoDiffCostFunction(lambda a, b: a - b, 2, [2, 2]), None, [x, x])


def test_constant_blocks_reduce_program():
    p = ctt.Problem()
    x, y = np.asarray([2.0, 2.0]), np.asarray([5.0, 5.0])
    p.add_residual_block(quad_cost(), None, [x])
    p.add_residual_block(quad_cost(), None, [y])
    p.set_parameter_block_constant(y)
    prog = CompiledProgram(p, device=CPU)
    assert prog.tangent_size == 2
    assert prog.num_residuals == 2
    np.testing.assert_allclose(prog.fixed_cost, 0.5 * 2 * 16.0)
    assert p.is_parameter_block_constant(y)
    p.set_parameter_block_variable(y)
    assert CompiledProgram(p, device=CPU).tangent_size == 4


def test_evaluate_cost_residuals_gradient_jacobian():
    p = ctt.Problem()
    x = np.asarray([3.0, 0.0])
    p.add_residual_block(quad_cost(), None, [x])
    cost, res, grad, J = p.evaluate(residuals=True, gradient=True, jacobian=True,
                                    device=CPU)
    np.testing.assert_allclose(cost, 0.5 * (4.0 + 1.0))
    np.testing.assert_allclose(sorted(res), [-1.0, 2.0])
    np.testing.assert_allclose(J, np.eye(2))
    np.testing.assert_allclose(grad, res @ J)


class PairCost(CostFunction):
    num_residuals = 2
    parameter_block_sizes = (2, 2)

    def residuals(self, params, data=None):
        a, b = params
        return torch.stack([a[0] * b[1] - 1.0, a[1] + b[0] ** 2])


def test_evaluate_crs_jacobian_matches_dense():
    """The CRS Jacobian agrees with the dense one entry for entry, the
    constant block's columns absent."""
    rng = np.random.default_rng(3)
    p = ctt.Problem()
    xs = [np.asarray(rng.standard_normal(2)) for _ in range(4)]
    for i in range(3):
        p.add_residual_block(PairCost(), None, [xs[i], xs[i + 1]])
    p.set_parameter_block_constant(xs[2])
    c_d, r_d, g_d, J_d = p.evaluate(residuals=True, gradient=True, jacobian=True,
                                    device=CPU)
    c_s, r_s, g_s, J_s = p.evaluate(residuals=True, gradient=True, jacobian=True,
                                    jacobian_format="crs", device=CPU)
    np.testing.assert_allclose(c_s, c_d)
    np.testing.assert_allclose(np.sort(r_s), np.sort(r_d))
    np.testing.assert_allclose(g_s, g_d)
    assert (J_s.num_rows, J_s.num_cols) == J_d.shape
    np.testing.assert_allclose(J_s.to_dense(), J_d, atol=1e-12)
    assert J_s.nnz < J_d.size
    assert J_s.rows[0] == 0 and J_s.rows[-1] == J_s.nnz
    for i in range(J_s.num_rows):
        assert np.all(np.diff(J_s.cols[J_s.rows[i]:J_s.rows[i + 1]]) > 0)


def test_evaluate_without_loss():
    p = ctt.Problem()
    x = np.asarray([3.0, 0.0])
    p.add_residual_block(quad_cost(), ctt.CauchyLoss(0.1), [x])
    assert p.evaluate(device=CPU) < p.evaluate(apply_loss_function=False, device=CPU)
    np.testing.assert_allclose(p.evaluate(apply_loss_function=False, device=CPU), 2.5)


def test_evaluate_residual_block():
    p = ctt.Problem()
    x = np.asarray([3.0, 0.0])
    rb = p.add_residual_block(quad_cost(), None, [x])
    cost, res, jacs = p.evaluate_residual_block(rb, device=CPU)
    np.testing.assert_allclose(cost, 2.5)
    np.testing.assert_allclose(res, [2.0, -1.0])
    np.testing.assert_allclose(jacs[0], np.eye(2))


def test_bounds_accessors():
    p = ctt.Problem()
    x = np.zeros(2)
    p.add_parameter_block(x)
    assert p.get_parameter_lower_bound(x, 0) == -np.inf
    p.set_parameter_lower_bound(x, 0, -1.0)
    p.set_parameter_upper_bound(x, 1, 2.0)
    assert p.get_parameter_lower_bound(x, 0) == -1.0
    assert p.get_parameter_upper_bound(x, 1) == 2.0
    assert p.get_parameter_upper_bound(x, 0) == np.inf


def test_mixed_kind_grouping():
    """Blocks of one cost but different manifolds split kinds."""
    p = ctt.Problem()
    q1, q2 = np.asarray([1.0, 0, 0, 0]), np.asarray([1.0, 0, 0, 0.0])
    cost = AutoDiffCostFunction(lambda q: q - torch.tensor([0.0, 1.0, 0, 0]), 4, [4])
    p.add_parameter_block(q1, manifold=ctt.QuaternionManifold())
    assert isinstance(p.get_manifold(q1), ctt.QuaternionManifold)
    p.add_parameter_block(q2)
    p.add_residual_block(cost, None, [q1])
    p.add_residual_block(cost, None, [q2])
    prog = CompiledProgram(p, device=CPU)
    assert len(prog.kinds) == 2
    assert prog.tangent_size == 3 + 4


def test_implicit_parameter_block_registration():
    p = ctt.Problem()
    x = np.zeros(2)
    p.add_residual_block(quad_cost(), None, [x])
    assert p.num_parameter_blocks() == 1
    assert p.parameter_block_for(x) is p.parameter_blocks()[0]
    assert len(p.residual_blocks()) == 1


def test_non_float64_rejected():
    with pytest.raises(TypeError):
        ctt.Problem().add_parameter_block(np.zeros(2, dtype=np.float32))


def test_repeated_solve_reads_fresh_values():
    """A second solve of one Problem starts from the values the caller
    wrote into its block (the JAX package's cached-program test, less the
    cache)."""
    p = ctt.Problem()
    x = np.array([5.0, 5.0])
    p.add_residual_block(quad_cost(), None, [x])
    opts = ctt.Options(fused_loop="ALWAYS", linear_solver_type=ctt.LinearSolverType.DENSE_QR,
                       max_num_iterations=20)
    assert ctt.solve(opts, p, device=CPU).is_solution_usable()
    np.testing.assert_allclose(x, 1.0, atol=1e-8)
    x[...] = [7.0, -3.0]
    s2 = ctt.solve(opts, p, device=CPU)
    np.testing.assert_allclose(x, 1.0, atol=1e-8)
    assert s2.initial_cost > 1.0


def test_add_residual_blocks_splits_its_data():
    """add_residual_blocks adds one block per row of its data's leaves."""
    p = ctt.Problem()
    x = np.zeros(2)
    cost = AutoDiffCostFunction(lambda v, d: v - d[0] * d[1], 2, [2])
    data = (np.array([1.0, 2.0]), np.array([3.0, 4.0]))
    ids = p.add_residual_blocks(cost, None, [[x], [x]], data=data)
    assert len(ids) == 2
    _, res = p.evaluate(residuals=True, device=CPU)
    np.testing.assert_allclose(res, [-3.0, -3.0, -8.0, -8.0])


# ------------------------------------------ twins of test_batched_problem.py


def _copy(b):
    return tbal.from_arrays(b.cameras, b.points, b.camera_index, b.point_index,
                            b.observations)


def test_batched_matches_per_block():
    b = tbal.perturb(tbal.synthetic_bal(num_cameras=5, num_points=40, visibility=0.5,
                                        noise=0.2, seed=3), 0.02, 0.1, 0.1)
    opts = ctt.Options(fused_loop="ALWAYS", linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                       max_num_iterations=40)
    s1 = ctt.solve(opts, tbal.build_problem(_copy(b))[0], device=CPU)
    s2 = ctt.solve(opts, tbal.build_problem_batched(_copy(b))[0], device=CPU)
    assert abs(s1.final_cost - s2.final_cost) < 1e-10 * max(1.0, s1.final_cost)
    assert s1.num_residual_blocks == s2.num_residual_blocks == b.num_observations


def test_batched_writes_back_into_2d_arrays():
    b = tbal.perturb(tbal.synthetic_bal(num_cameras=4, num_points=30, visibility=0.5,
                                        noise=0.1, seed=5), 0.02, 0.1, 0.1)
    p, cam_values, _ = tbal.build_problem_batched(b)
    before = cam_values.copy()
    ctt.solve(ctt.Options(fused_loop="ALWAYS", linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                          max_num_iterations=10), p, device=CPU)
    assert not np.allclose(cam_values, before)


def test_batched_constant_array_contributes_fixed_cost():
    p = ctt.Problem()
    xs = p.add_parameter_block_array(np.full((3, 2), 2.0))
    ys = p.add_parameter_block_array(np.full((3, 2), 5.0))
    cost = AutoDiffCostFunction(lambda v: v - 1.0, 2, [2])
    p.add_residual_block_batch(cost, None, [(xs, np.arange(3))])
    p.add_residual_block_batch(cost, None, [(ys, np.arange(3))])
    p.set_parameter_block_array_constant(ys)
    s = ctt.solve(ctt.Options(fused_loop="ALWAYS", linear_solver_type=ctt.LinearSolverType.DENSE_QR,
                              max_num_iterations=30), p, device=CPU)
    np.testing.assert_allclose(s.fixed_cost, 0.5 * 3 * 2 * 16.0)
    np.testing.assert_allclose(s.final_cost, s.fixed_cost, atol=1e-9)


def test_batched_with_manifold_and_bounds():
    p = ctt.Problem()
    q = np.tile(np.asarray([1.0, 0, 0, 0]), (4, 1))
    qs = p.add_parameter_block_array(q, manifold=ctt.QuaternionManifold())
    target = np.asarray([np.cos(0.2), np.sin(0.2), 0, 0])
    cost = AutoDiffCostFunction(lambda v, t: v - t, 4, [4])
    p.add_residual_block_batch(cost, None, [(qs, np.arange(4))],
                               data=np.tile(target, (4, 1)))
    opts = ctt.Options(fused_loop="ALWAYS", linear_solver_type=ctt.LinearSolverType.DENSE_QR,
                       max_num_iterations=40)
    assert ctt.solve(opts, p, device=CPU).final_cost < 1e-12
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-10)

    p2 = ctt.Problem()
    v = np.full((3, 1), 5.0)
    vs = p2.add_parameter_block_array(v)
    p2.set_parameter_block_array_bounds(vs, lower=2.0)
    p2.add_residual_block_batch(AutoDiffCostFunction(lambda x: x - 1.0, 1, [1]), None,
                                [(vs, np.arange(3))])
    s = ctt.solve(opts, p2, device=CPU)
    assert s.is_constrained
    np.testing.assert_allclose(v, 2.0, atol=1e-9)


def test_batched_validation_errors():
    p = ctt.Problem()
    xs = p.add_parameter_block_array(np.zeros((3, 2)))
    with pytest.raises(ValueError):
        p.add_residual_block_batch(AutoDiffCostFunction(lambda v: v, 2, [2]), None,
                                   [(xs, np.asarray([0, 1, 5]))])
    with pytest.raises(ValueError):
        p.add_residual_block_batch(AutoDiffCostFunction(lambda v: v, 3, [3]), None,
                                   [(xs, np.arange(3))])


# ------------------------------------- twins of test_evaluator.py's layout


def build_fixture(P, lib):
    x = np.asarray([1.0, 2.0])
    y = np.asarray([3.0, 4.0, 5.0])
    z = np.asarray([6.0, 7.0, 8.0, 9.0])
    costA = P.AutoDiffCostFunction(lambda a, b: lib.stack([lib.sum(a), lib.sum(b)]), 2, [2, 3])
    costB = P.AutoDiffCostFunction(lambda c: 2.0 * c, 4, [4])
    p = P.Problem()
    p.add_residual_block(costA, None, [x, y])
    p.add_residual_block(costB, None, [z])
    return p


def test_dense_jacobian_layout():
    prog = CompiledProgram(build_fixture(ctt, torch), device=CPU)
    cost, res, grad, J = prog.evaluate_dense(prog.initial_state())
    J = J.numpy()
    assert J.shape == (6, 9)
    offs = {f.asize: f.tangent_offset for f in prog.families}
    np.testing.assert_allclose(J[0, offs[2]:offs[2] + 2], [1, 1])
    np.testing.assert_allclose(J[0, offs[3]:offs[3] + 3], 0)
    np.testing.assert_allclose(J[1, offs[3]:offs[3] + 3], [1, 1, 1])
    np.testing.assert_allclose(J[2:6, offs[4]:offs[4] + 4], 2.0 * np.eye(4))
    np.testing.assert_allclose(grad.numpy(), J.T @ res.numpy())
    np.testing.assert_allclose(float(cost), 0.5 * float(torch.sum(res ** 2)))


def test_block_jacobian_consistent_with_dense():
    prog = CompiledProgram(build_fixture(ctt, torch), device=CPU)
    xs = prog.initial_state()
    Jd = prog.evaluate_dense(xs)[3]
    values = prog.evaluate_bsr(xs)[3]
    meta = bsr.build_meta(prog)
    dense = bsr.to_dense(meta, values, bsr.dense_index(meta, CPU), prog.num_residuals)
    np.testing.assert_allclose(dense.numpy(), Jd.numpy())
    np.testing.assert_allclose(
        bsr.to_crs(meta, [[J.numpy() for J in k] for k in values]).to_dense(), Jd.numpy())


def test_residual_vector_row_order_is_kind_major():
    prog = CompiledProgram(build_fixture(ctt, torch), device=CPU)
    res = prog.evaluate_residuals(prog.initial_state())[1].numpy()
    np.testing.assert_allclose(res[:2], [3.0, 12.0])
    np.testing.assert_allclose(res[2:], 2.0 * np.asarray([6, 7, 8, 9.0]))


def test_layout_matches_jax():
    """Families, offsets and kinds of a program with individual blocks, a
    constant block, a bounded block and a constant array equal the JAX
    package's (sort_rows=True, as both solvers compile)."""
    def build(P, lib):
        p = build_fixture(P, lib)
        w = np.asarray([0.5, 0.5])
        p.add_residual_block(P.AutoDiffCostFunction(lambda a: a * a, 2, [2]), None, [w])
        p.set_parameter_block_constant(w)
        u = np.asarray([4.0, 4.0])
        p.add_residual_block(P.AutoDiffCostFunction(lambda a: a - 1.0, 2, [2]), None, [u])
        p.set_parameter_upper_bound(u, 1, 3.0)
        arr = p.add_parameter_block_array(np.ones((3, 2)))
        p.add_residual_block_batch(P.AutoDiffCostFunction(lambda a: a, 2, [2]), None,
                                   [(arr, np.array([2, 0, 1]))])
        p.set_parameter_block_array_constant(arr)
        return p

    jp = JaxProgram(build(ct, jnp), sort_rows=True)
    tp = CompiledProgram(build(ctt, torch), device=CPU)
    assert [(f.asize, f.num_var, f.count, f.state_offset, f.tangent_offset)
            for f in tp.families] == [(f.asize, f.num_var, f.count, f.state_offset,
                                       f.tangent_offset) for f in jp.families]
    assert (tp.state_size, tp.tangent_size, tp.num_residuals) == (
        jp.state_size, jp.tangent_size, jp.num_residuals)
    assert tp.fixed_cost == pytest.approx(jp.fixed_cost, rel=1e-15)
    assert tp.has_bounds() and jp.has_bounds()
    for a, b in zip(tp.ambient_bounds() + tp.tangent_box(), jp.ambient_bounds()
                    + jp.tangent_box()):
        np.testing.assert_array_equal(a, np.asarray(b))
    x = tp.initial_state()
    c, r, g, J = tp.evaluate_dense(x)
    jc, jr, jg, jJ = jp.evaluate_dense(jp.initial_state())
    assert float(c) == pytest.approx(float(jc), rel=1e-15)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-15)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-15)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), rtol=1e-15)
    step = torch.linspace(-1.0, 1.0, tp.tangent_size, dtype=torch.float64)
    np.testing.assert_allclose(tp.plus(x, step).numpy(),
                               np.asarray(jp.plus(jp.initial_state(), step.numpy())),
                               rtol=1e-15)


# ------------------------------------------------------- the user ordering


def _ba_pair(b, per_block):
    jb = jbal.BALProblem(b.cameras.copy(), b.points.copy(), b.camera_index.copy(),
                         b.point_index.copy(), b.observations.copy())
    if per_block:
        return jbal.build_problem(jb), tbal.build_problem(_copy(b))
    return jbal.build_problem_batched(jb), tbal.build_problem_batched(_copy(b))


def _small_ba():
    return tbal.perturb(tbal.synthetic_bal(num_cameras=5, num_points=60, visibility=0.5,
                                           seed=3), 0.01, 0.05, 0.05)


@pytest.mark.parametrize("case", ["arrays", "blocks", "one_group", "partial"])
def test_e_set_from_user_ordering_matches_jax(case):
    """Group 0's families, from array handles or individual blocks; None
    for an ordering of one group; a group 0 that covers part of a family
    raises, in both packages."""
    b = _small_ba()
    (jp, jc, jq), (tp, tc, tq) = _ba_pair(b, per_block=case != "arrays")
    jprog = JaxProgram(jp, sort_rows=True)
    tprog = CompiledProgram(tp, device=CPU)
    if case == "arrays":
        jo = [[jp.parameter_block_arrays()[1]], [jp.parameter_block_arrays()[0]]]
        to = [[tp.parameter_block_arrays()[1]], [tp.parameter_block_arrays()[0]]]
    elif case == "blocks":
        jo, to = [list(jq), list(jc)], [list(tq), list(tc)]
    elif case == "one_group":
        jo, to = [list(jq)], [list(tq)]
    else:
        jo, to = [list(jq[:10]), list(jc)], [list(tq[:10]), list(tc)]
    if case == "partial":
        with pytest.raises(ValueError):
            jordering.e_set_from_user_ordering(jprog, jo)
        with pytest.raises(ValueError):
            tordering.e_set_from_user_ordering(tprog, to)
        return
    want = jordering.e_set_from_user_ordering(jprog, jo)
    assert tordering.e_set_from_user_ordering(tprog, to) == want
    assert want is None if case == "one_group" else want == [1]


# ----------------------------------------------- the slice's paths on the CPU


def assert_rows(out, ref, rel=1e-9):
    """The same termination and rows, each row's cost to `rel` relative."""
    assert out.termination_type.name == ref.termination_type.name
    assert len(out.iterations) == len(ref.iterations)
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=rel)
        assert c.step_is_successful == a.step_is_successful
    assert out.final_cost == pytest.approx(ref.final_cost, rel=rel)


def _solve_pair(jprob, tprob, lst, dtype="float64", **kw):
    jopts = {k: v for k, v in kw.items() if k != "t_ordering"}
    if "j_ordering" in jopts:
        jopts["linear_solver_ordering"] = jopts.pop("j_ordering")
    ref = ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType[lst],
                              evaluation_dtype=dtype, fused_loop="ALWAYS", **jopts), jprob)
    tk = {k: v for k, v in kw.items() if k != "j_ordering"}
    if "preconditioner_type" in tk:
        tk["preconditioner_type"] = ctt.PreconditionerType[tk["preconditioner_type"].name]
    if "t_ordering" in tk:
        tk["linear_solver_ordering"] = tk.pop("t_ordering")
    kn.reset_counts()
    out = ctt.solve(ctt.Options(fused_loop="ALWAYS", linear_solver_type=ctt.LinearSolverType[lst],
                                evaluation_dtype=dtype, **tk), tprob, device=CPU)
    return ref, out, {k.__name__: k.plain_calls for k in kn.KERNELS}


@pytest.fixture(scope="module")
def gauge_fixed():
    b = _small_ba()
    out = {}
    for lst in ("DENSE_SCHUR", "ITERATIVE_SCHUR"):
        for dtype in ("float64", "float32"):
            (jp, jc, _), (tp, tc, _) = _ba_pair(b, per_block=True)
            jp.set_parameter_block_constant(jc[0])
            tp.set_parameter_block_constant(tc[0])
            out[(lst, dtype)] = _solve_pair(jp, tp, lst, dtype)
    return out


@pytest.mark.parametrize("lst", ["DENSE_SCHUR", "ITERATIVE_SCHUR"])
def test_gauge_fixed_ba_matches_jax(gauge_fixed, lst):
    """Path (a): BA built one block at a time, its first camera held
    constant. float64: the same termination and rows, each row's cost to
    1e-9 relative, the same CG counts; the jt kernels ran (their plain
    versions, the constant camera the row plan's sentinel)."""
    ref, out, calls = gauge_fixed[(lst, "float64")]
    assert_rows(out, ref)
    assert ([r.linear_solver_iterations for r in out.iterations]
            == [r.linear_solver_iterations for r in ref.iterations])
    assert out.num_effective_parameters_reduced == 4 * 9 + 60 * 3
    assert calls["eval_fused"] > 0 and calls["post_eval_fused"] > 0
    assert calls["schur_assembly" if lst == "DENSE_SCHUR" else "isc_matvec"] > 0


@pytest.mark.parametrize("lst", ["DENSE_SCHUR", "ITERATIVE_SCHUR"])
def test_gauge_fixed_ba_float32_final_cost(gauge_fixed, lst):
    """Path (a) in float32: the final cost within 1e-5 of the JAX one (CG
    counts follow rounding and are not compared)."""
    ref, out, _ = gauge_fixed[(lst, "float32")]
    assert out.is_solution_usable() and ref.is_solution_usable()
    assert out.final_cost == pytest.approx(ref.final_cost, rel=1e-5)


def test_gauge_fixed_camera_stays_put():
    """The constant camera's values are written back unchanged."""
    p, cams, _ = tbal.build_problem(_copy(_small_ba()))
    before = cams[0].copy()
    p.set_parameter_block_constant(cams[0])
    ctt.solve(ctt.Options(fused_loop="ALWAYS",
                          linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR), p,
              device=CPU)
    np.testing.assert_array_equal(cams[0], before)


def test_user_ordering_matches_default_and_jax():
    """Path (f): DENSE_SCHUR with linear_solver_ordering [[points],
    [cameras]] picks the e-set of the default ordering: the same rows as
    the default solve bit for bit, and the JAX rows to 1e-9 relative."""
    b = _small_ba()
    (jp, _, _), (tp, _, _) = _ba_pair(b, per_block=False)
    jo = [[jp.parameter_block_arrays()[1]], [jp.parameter_block_arrays()[0]]]
    to = [[tp.parameter_block_arrays()[1]], [tp.parameter_block_arrays()[0]]]
    ref, out, _ = _solve_pair(jp, tp, "DENSE_SCHUR", j_ordering=jo, t_ordering=to)
    assert_rows(out, ref)
    default = ctt.solve(ctt.Options(fused_loop="ALWAYS",
                                    linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR),
                        tbal.build_problem_batched(_copy(b))[0], device=CPU)
    assert [r.cost for r in out.iterations] == [r.cost for r in default.iterations]


@pytest.mark.parametrize("lst", ["DENSE_SCHUR", "ITERATIVE_SCHUR"])
def test_libmv_constant_intrinsics_matches_jax(lst):
    """Path (e): the libmv bundle adjuster with refine_intrinsics=False on
    the flat path, the constant intrinsics family in no plan: the same
    termination and rows, each row's cost to 1e-9 relative, and the
    intrinsics unchanged."""
    lp = small_libmv()
    tp, _, _, intr = tlibmv.build_problem(chip_smoke.fresh(lp), refine_intrinsics=False)
    before = intr.copy()
    ref, out, calls = _solve_pair(
        jlibmv.build_problem(jax_lp(lp), refine_intrinsics=False)[0], tp, lst,
        preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI)
    assert_rows(out, ref)
    np.testing.assert_array_equal(intr, before)
    assert out.schur_structure_used == ref.schur_structure_used == "2,3,6"
    assert calls["segment_block_expand"] > 0 and calls["eval_fused"] == 0


def test_read_bal_file_matches_jax(tmp_path):
    """read_bal_file reads the BAL text format as the JAX package's does:
    a small problem written here, the same arrays back from both."""
    b = _small_ba()
    path = tmp_path / "problem.txt"
    lines = [f"{b.num_cameras} {b.num_points} {b.num_observations}"]
    lines += [f"{c} {p} {o[0]:.17g} {o[1]:.17g}" for c, p, o in zip(
        b.camera_index, b.point_index, b.observations)]
    lines += [f"{v:.17g}" for v in np.concatenate([b.cameras.ravel(), b.points.ravel()])]
    path.write_text("\n".join(lines) + "\n")
    got, want = tbal.read_bal_file(path), jbal.read_bal_file(path)
    for name in ("cameras", "points", "camera_index", "point_index", "observations"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(got.cameras, b.cameras)
    assert got.camera_index.dtype == want.camera_index.dtype
