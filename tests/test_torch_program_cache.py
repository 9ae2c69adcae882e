"""The compiled-program cache of the port (CompiledProgram.cached,
Problem._compiled_cache, the fused minimizers cached on a program) on the
CPU: twins of tests/test_problem.py:179-215, a new program after every
kind of structural mutation, the device in the key, constant blocks read
live, and repeated solves that reuse the program and its fused minimizer
and repeat a fresh solve's rows bit for bit."""
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu.program import CompiledProgram as JaxProgram

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.program import CompiledProgram
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def quad_cost(pkg=ctt):
    return pkg.AutoDiffCostFunction(lambda x: x - 1.0, 2, [2])


def test_compiled_program_cache_reuse_and_invalidation():
    """Both packages: an unmutated Problem gets its program back, another
    key another program, and a structural change or a bound a new one."""
    for pkg, cls in ((ct, JaxProgram), (ctt, CompiledProgram)):
        kw = {} if pkg is ct else dict(device="cpu")
        p = pkg.Problem()
        x = np.zeros(2)
        p.add_residual_block(quad_cost(pkg), None, [x])
        prog1 = cls.cached(p, sort_rows=True, **kw)
        assert cls.cached(p, sort_rows=True, **kw) is prog1
        assert cls.cached(p, sort_rows=False, **kw) is not prog1
        y = np.zeros(2)
        p.add_residual_block(quad_cost(pkg), None, [y])
        assert cls.cached(p, sort_rows=True, **kw) is not prog1
        prog4 = cls.cached(p, sort_rows=True, **kw)
        p.parameter_block_for(x).set_lower_bound(0, -1.0)
        assert cls.cached(p, sort_rows=True, **kw) is not prog4


def test_repeated_solve_uses_cache_and_updates_values():
    """A second solve after new values (not a new structure) hits the cache
    and starts from the new values, in both packages, with the same
    answers within 1e-12."""
    out = []
    for pkg in (ct, ctt):
        extra = {} if pkg is ct else dict(device="cpu")
        p = pkg.Problem()
        x = np.array([5.0, 5.0])
        p.add_residual_block(quad_cost(pkg), None, [x])
        s1 = pkg.solve(pkg.Options(max_num_iterations=20), p, **extra)
        assert s1.is_solution_usable()
        np.testing.assert_allclose(x, 1.0, atol=1e-8)
        key = (True, "float64", True) if pkg is ct else (True, "float64", True, "cpu")
        prog = p._compiled_cache[key]
        x[...] = [7.0, -3.0]
        s2 = pkg.solve(pkg.Options(max_num_iterations=20), p, **extra)
        assert p._compiled_cache[key] is prog
        assert s2.is_solution_usable()
        np.testing.assert_allclose(x, 1.0, atol=1e-8)
        assert s2.initial_cost > 1.0
        out.append((s2.initial_cost, s2.final_cost))
    np.testing.assert_allclose(out[1], out[0], rtol=1e-12, atol=1e-20)


def _mutations():
    """(name, mutate(problem, handles)) for each kind of structural change."""
    def pb(p, h):
        return p.parameter_block_for(h["x"])

    return [
        ("add_parameter_block", lambda p, h: p.add_parameter_block(np.zeros(3))),
        ("add_residual_block", lambda p, h: p.add_residual_block(quad_cost(), None, [np.zeros(2)])),
        ("add_residual_blocks", lambda p, h: p.add_residual_blocks(
            quad_cost(), None, [[np.zeros(2)], [np.zeros(2)]])),
        ("remove_residual_block", lambda p, h: p.remove_residual_block(h["rb"])),
        ("remove_parameter_block", lambda p, h: p.remove_parameter_block(h["x"])),
        ("set_parameter_block_constant", lambda p, h: p.set_parameter_block_constant(h["x"])),
        ("set_parameter_block_variable", lambda p, h: p.set_parameter_block_variable(h["c"])),
        ("set_manifold", lambda p, h: p.set_manifold(h["x"], ctt.SubsetManifold(2, [0]))),
        ("set_parameter_lower_bound", lambda p, h: p.set_parameter_lower_bound(h["x"], 0, -2.0)),
        ("set_parameter_upper_bound", lambda p, h: p.set_parameter_upper_bound(h["x"], 1, 2.0)),
        ("ParameterBlock.set_lower_bound", lambda p, h: pb(p, h).set_lower_bound(1, -3.0)),
        ("ParameterBlock.set_upper_bound", lambda p, h: pb(p, h).set_upper_bound(0, 3.0)),
        ("add_parameter_block_array", lambda p, h: p.add_parameter_block_array(np.zeros((2, 2)))),
        ("add_residual_block_batch", lambda p, h: p.add_residual_block_batch(
            quad_cost(), None, [(h["arr"], np.array([0, 1]))])),
        ("remove_residual_block_batch", lambda p, h: p.remove_residual_block_batch(h["batch"])),
        ("set_parameter_block_array_constant",
         lambda p, h: p.set_parameter_block_array_constant(h["arr"])),
        ("set_parameter_block_array_bounds", lambda p, h: p.set_parameter_block_array_bounds(
            h["arr"], lower=np.full(2, -5.0))),
    ]


@pytest.mark.parametrize("name,mutate", _mutations(), ids=[m[0] for m in _mutations()])
def test_every_structural_mutation_gives_a_new_program(name, mutate):
    """Each kind of structural change bumps structure_version and the
    cache builds a new program; a value change does not."""
    p = ctt.Problem()
    h = {"x": np.array([2.0, 3.0]), "c": np.array([0.5, 0.5])}
    h["rb"] = p.add_residual_block(quad_cost(), None, [h["x"]])
    p.add_residual_block(quad_cost(), None, [h["c"]])
    p.set_parameter_block_constant(h["c"])
    h["arr"] = p.add_parameter_block_array(np.array([[1.0, 2.0], [3.0, 4.0]]))
    h["batch"] = p.add_residual_block_batch(quad_cost(), None, [(h["arr"], np.array([1, 0]))])
    prog = CompiledProgram.cached(p, sort_rows=True, device="cpu")
    h["x"][...] = [9.0, 9.0]  # values are read live: no new program
    assert CompiledProgram.cached(p, sort_rows=True, device="cpu") is prog
    v = p.structure_version
    mutate(p, h)
    assert p.structure_version > v
    assert CompiledProgram.cached(p, sort_rows=True, device="cpu") is not prog


def test_problem_evaluate_builds_a_fresh_program():
    """Problem.evaluate keeps building its own program (in the add order),
    as the JAX one does: the cache is the solver's."""
    p = ctt.Problem()
    p.add_residual_block(quad_cost(), None, [np.array([3.0, 0.0])])
    assert p.evaluate(device="cpu") == 2.5
    assert p._compiled_cache == {}


def test_cache_is_keyed_on_the_device():
    """A program built for a card never serves a CPU solve: the device is
    part of the key. An entry under a card's key (a stand-in here: this
    machine has none) is passed over by a CPU request and a CPU solve,
    which build and use their own."""
    p = ctt.Problem()
    p.add_residual_block(quad_cost(), None, [np.zeros(2)])
    card_key = (True, "float64", True, "cuda:0")
    sentinel = object()
    p._compiled_cache[card_key] = sentinel
    cpu = CompiledProgram.cached(p, sort_rows=True, device="cpu")
    assert cpu is not sentinel and cpu.device == torch.device("cpu")
    s = ctt.solve(ctt.Options(), p, device="cpu")
    assert s.is_solution_usable()
    assert p._compiled_cache[card_key] is sentinel
    assert p._compiled_cache[(True, "float64", True, "cpu")] is cpu


def test_constant_values_are_read_live():
    """The values of constant blocks change between solves without a
    structural change: a constant block in the state and the cost of a
    residual block whose parameters are all constant are both read anew,
    so the repeated solve equals a fresh one bit for bit."""
    def build(c_val, f_val):
        p = ctt.Problem()
        x, c, f = np.array([2.0, 3.0]), np.array(c_val), np.array(f_val)
        two = ctt.AutoDiffCostFunction(lambda a, b: a - b, 2, [2, 2])
        p.add_residual_block(two, None, [x, c])
        p.add_residual_block(quad_cost(), None, [f])
        p.set_parameter_block_constant(c)
        p.set_parameter_block_constant(f)
        return p, x, c, f

    p, x, c, f = build([1.0, 1.0], [4.0, 4.0])
    opts = ctt.Options(max_num_iterations=10)
    ctt.solve(opts, p, device="cpu")
    prog = next(iter(p._compiled_cache.values()))
    x[...], c[...], f[...] = [2.0, 3.0], [-1.0, 5.0], [0.0, 2.0]
    s2 = ctt.solve(opts, p, device="cpu")
    assert next(iter(p._compiled_cache.values())) is prog
    q, xq, _, _ = build([-1.0, 5.0], [0.0, 2.0])
    s3 = ctt.solve(opts, q, device="cpu")
    assert s2.fixed_cost == s3.fixed_cost == 0.5 * (1.0 + 1.0)
    assert [r.cost for r in s2.iterations] == [r.cost for r in s3.iterations]
    np.testing.assert_array_equal(x, xq)


def _bal_problem():
    b = tbal.perturb(tbal.synthetic_bal(num_cameras=5, num_points=80, visibility=0.5, seed=4),
                     0.01, 0.05, 0.05, seed=1)
    return tbal.build_problem_batched(b)


@pytest.mark.parametrize("kw", [
    dict(linear_solver_type="DENSE_SCHUR", fused_loop="ALWAYS"),
    dict(linear_solver_type="ITERATIVE_SCHUR", fused_loop="ALWAYS"),
    dict(linear_solver_type="DENSE_SCHUR", fused_loop="ALWAYS", use_inner_iterations=True),
    dict(linear_solver_type="DENSE_SCHUR", fused_loop="NEVER", use_inner_iterations=True),
    dict(minimizer_type="LINE_SEARCH", fused_loop="ALWAYS", max_num_iterations=15),
    dict(minimizer_type="LINE_SEARCH", fused_loop="NEVER", max_num_iterations=15),
], ids=["ds_fused", "is_fused", "ds_fused_inner", "ds_host_inner", "ls_fused", "ls_host"])
def test_repeated_solve_equals_a_fresh_one_bit_for_bit(kw):
    """Solve, put the starting values back in place, solve again: the same
    program and (in the fused loop) the same fused minimizer serve the
    repeat, whose rows equal the first solve's and a fresh Problem's bit
    for bit; nothing a minimizer keeps (radius, LBFGS buffers, the inner
    iterations' switch) leaks into the next solve."""
    kw = dict(kw)
    if "linear_solver_type" in kw:
        kw["linear_solver_type"] = ctt.LinearSolverType[kw["linear_solver_type"]]
    if "minimizer_type" in kw:
        kw["minimizer_type"] = ctt.MinimizerType[kw["minimizer_type"]]
    opts = ctt.Options(**kw)
    p, cams, pts = _bal_problem()
    c0, p0 = cams.copy(), pts.copy()
    s1 = ctt.solve(opts, p, device="cpu")
    (prog,) = p._compiled_cache.values()
    fused = dict(prog._minimizer_cache)
    cams[...], pts[...] = c0, p0
    s2 = ctt.solve(opts, p, device="cpu")
    assert next(iter(p._compiled_cache.values())) is prog
    assert prog._minimizer_cache == fused
    assert bool(fused) == (kw["fused_loop"] == "ALWAYS")
    s3 = ctt.solve(opts, _bal_problem()[0], device="cpu")
    rows = [[(r.cost, r.gradient_max_norm, r.step_norm) for r in s.iterations]
            for s in (s1, s2, s3)]
    assert rows[0] == rows[1] == rows[2]
    assert s1.final_cost == s2.final_cost == s3.final_cost
    assert s1.num_host_syncs == s2.num_host_syncs == s3.num_host_syncs
