"""The port's multi-device tiers over a compiled program
(ceres_tpu_torch/parallel/mesh.py, sharded_program.py and
solvers/fused_lm.solve_sharded_fused) against the JAX package's, on the
CPU: world sizes 1, 2 and 4 over gloo, each rank a spawned process.
ShardedProgramEvaluator and one sharded_gradient_descent_step,
solve_sharded (the host trust-region loop, CGNR sharded), the sharded
fused CGNR, and the generic halo tier on angle-axis and quaternion
cameras, at the JAX tests' sizes (tests/test_sharding.py).

One module-scoped launch of four ranks runs every case at each world
size (twice, the repeat compared bit for bit). References: the JAX
evaluation of the unsharded program; solve_sharded and
solve_sharded_fused on a 1-device JAX mesh (the unsharded function; the
JAX slow tests hold it to the 8-device one); the generic halo tier on
the JAX 8-device CPU mesh, as its fast-tier tests run it. The CG budget
is pinned (eta = 1e-30, 8 iterations), as tests/test_sharding.py:441
pins it. Tolerances: the cost 1e-10 relative, the state 1e-8 relative to
its largest entry with 1e-10 absolute."""
import numpy as np
import pytest

import ceres_tpu as ct
from ceres_tpu.models import bal as jbal
from ceres_tpu.parallel import sharded_ba as jsb
from ceres_tpu.parallel import sharded_program as jsp
from ceres_tpu.parallel.mesh import make_mesh, solve_sharded
from ceres_tpu.program import CompiledProgram
from ceres_tpu.solvers.fused_lm import solve_sharded_fused

from ceres_tpu_torch.parallel import mesh as tmesh
from ceres_tpu_torch.parallel import tiers

WORLD = (1, 2, 4)
PIN = dict(eta=1e-30, max_linear_solver_iterations=8)


def _arrays(b):
    return (np.asarray(b.cameras, np.float64), np.asarray(b.points, np.float64),
            np.asarray(b.camera_index), np.asarray(b.point_index),
            np.asarray(b.observations, np.float64))


PROBLEMS = {
    # tests/test_sharding.py:21, :87, :221 and :422's instances
    "ev": _arrays(jbal.synthetic_bal(num_cameras=4, num_points=37, visibility=0.5,
                                     noise=0.2, seed=5)),
    "ss": _arrays(jbal.perturb(jbal.synthetic_bal(num_cameras=6, num_points=60,
                                                  visibility=0.5, noise=0.2, seed=7),
                               0.02, 0.1, 0.1)),
    "ssf": _arrays(jbal.perturb(jbal.synthetic_bal(6, 60, 0.5, noise=0.1, seed=3),
                                0.01, 0.05, 0.05)),
    "q0": _arrays(jbal.perturb(jbal.synthetic_bal(num_cameras=8, num_points=120,
                                                  visibility=0.4, noise=0.3, seed=0),
                               0.02, 0.1, 0.1, seed=1)),
    "q5": _arrays(jbal.perturb(jbal.synthetic_bal(num_cameras=8, num_points=120,
                                                  visibility=0.4, noise=0.3, seed=5),
                               0.02, 0.1, 0.1, seed=6)),
}
CASES = [
    dict(name="evaluator", tier="evaluator", problem="ev", lr=1e-6),
    dict(name="solve_sharded", tier="solve_sharded", problem="ss", max_num_iterations=10,
         **PIN),
    dict(name="solve_sharded_fused", tier="solve_sharded_fused", problem="ssf",
         max_num_iterations=10, **PIN),
    dict(name="program_halo", tier="program_halo", problem="q0", k=2, max_num_iterations=6,
         options=PIN),
    dict(name="program_halo_quat", tier="program_halo", problem="q5", quat=True, k=2,
         max_num_iterations=8, options=PIN),
]
NAMES = [c["name"] for c in CASES]


def _problem(name, quat=False):
    b = jbal.BALProblem(*(a.copy() for a in PROBLEMS[name]))
    return (jbal.build_problem_batched_quat if quat else jbal.build_problem_batched)(b)


def _jax_reference(case):
    """{"cost", and "gradient" / "x1" or "x" (the state vector)}."""
    name = case["name"]
    if name == "evaluator":
        prog = CompiledProgram(_problem("ev")[0])
        x = prog.initial_state()
        cost, _, g = prog.evaluate_grad(x)
        return {"cost": float(cost), "gradient": np.asarray(g),
                "x1": np.asarray(prog._plus_impl(x, -case["lr"] * g))}
    if name.startswith("solve_sharded"):
        problem, cams, pts = _problem(case["problem"])
        fn = solve_sharded if name == "solve_sharded" else solve_sharded_fused
        s = fn(ct.Options(linear_solver_type=ct.LinearSolverType.CGNR,
                          max_num_iterations=case["max_num_iterations"], **PIN),
               problem, make_mesh(1))
        return {"cost": s.final_cost, "x": np.concatenate([cams.ravel(), pts.ravel()]),
                "rows": [r.cost for r in s.iterations]}
    prog = CompiledProgram(_problem(case["problem"], case.get("quat", False))[0])
    x, info, _ = jsp.solve_program_camera_halo(
        prog, jsb.ShardedLMOptions(**PIN), max_num_iterations=case["max_num_iterations"],
        mesh=jsb.make_mesh(8, axis="cam"), k=case["k"])
    return {"cost": info["final_cost"], "x": np.asarray(x), "iterations": info["iterations"]}


def _state(r):
    """A port result's state vector."""
    if "x" in r:
        return r["x"]
    if "x1" in r:
        return r["x1"]
    return np.concatenate([np.ravel(r["cams"]), np.ravel(r["pts"])])


@pytest.fixture(scope="module")
def _launched():
    """(runs, jax_refs): one launch of four ranks, world size 4 over all
    of them, then 2 and 1 over subgroups side by side
    (tiers.run_world_sizes), so that the ranks start once; the JAX
    references are computed here while the ranks run."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(tmesh.launch, tiers.run_world_sizes, max(WORLD), "gloo", "cpu",
                        240, (PROBLEMS, CASES, WORLD))
        refs = {c["name"]: _jax_reference(c) for c in CASES}
        ranks = fut.result()
    return {n: [r[n] for r in ranks if n in r] for n in WORLD}, refs


@pytest.fixture(scope="module")
def runs(_launched):
    """{world size: [each rank's run_cases result]}."""
    return _launched[0]


@pytest.fixture(scope="module")
def jax_refs(_launched):
    return _launched[1]


def _close(got, ref, rtol, atol=0.0):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max() + atol


@pytest.mark.parametrize("n", WORLD)
@pytest.mark.parametrize("name", NAMES)
def test_program_tier_matches_jax(runs, jax_refs, name, n):
    ref = jax_refs[name]
    for rank in runs[n]:
        r = rank["cases"][name]
        assert r["cost"] == pytest.approx(ref["cost"], rel=1e-10)
        if name == "evaluator":
            _close(r["gradient"], ref["gradient"], 1e-12)
            _close(r["x1"], ref["x1"], 1e-12)
            assert r["cost_only"] == pytest.approx(ref["cost"], rel=1e-12)
            continue
        _close(_state(r), ref["x"], 1e-8, 1e-10)
        if "rows" in ref:
            np.testing.assert_allclose(r["rows"], ref["rows"], rtol=1e-10)
        if "iterations" in ref:
            assert r["iterations"] == ref["iterations"]
    first = runs[n][0]["cases"][name]
    for rank in runs[n][1:]:
        assert rank["cases"][name]["cost"] == first["cost"]
        assert np.array_equal(_state(rank["cases"][name]), _state(first))


@pytest.mark.parametrize("n", WORLD)
@pytest.mark.parametrize("name", NAMES)
def test_program_tier_repeats_bit_for_bit(runs, name, n):
    for rank in runs[n]:
        assert rank["cases"][name]["repeat_bitwise"]


@pytest.mark.parametrize("name", NAMES)
def test_program_tier_world_sizes_agree(runs, name):
    base = runs[1][0]["cases"][name]
    for n in WORLD[1:]:
        r = runs[n][0]["cases"][name]
        assert r["cost"] == pytest.approx(base["cost"], rel=1e-10)
        _close(_state(r), _state(base), 1e-8, 1e-10)


@pytest.mark.parametrize("n", WORLD)
def test_sharded_cgnr_runs_rows_6_7_9_on_every_rank(runs, n):
    """Each rank's J x, J'u and post-evaluation run over its own rows
    through the plain versions of segment_block_sum and
    segment_block_expand (the point side, sorted) and unsorted_segment_sum
    (the camera side): their kernels on a card."""
    for rank in runs[n]:
        r = rank["cases"]["solve_sharded_fused"]
        for name in ("segment_block_sum", "segment_block_expand", "unsorted_segment_sum"):
            assert r["plain_calls"].get(name, 0) > 0, (name, r["plain_calls"])
        assert "normal_matvec" not in r["plain_calls"]


@pytest.mark.parametrize("n", WORLD)
@pytest.mark.parametrize("name", ("evaluator", "program_halo", "program_halo_quat"))
def test_program_tier_collectives_within_the_jax_audit(runs, name, n):
    """The generic evaluator: no all-to-all, at least one all-reduce
    (tests/test_collective_audit.py:141-157); the program-halo tier, as
    the halo tier (:160-221, :242): no all-gather inside the iterations
    (the two it makes gather the result's tables), 1 to 6 + 2 cg
    all-to-alls an LM iteration of at most the cut's rows, no all-reduce
    of P_pad rows (tiers.audit)."""
    tier = next(c["tier"] for c in CASES if c["name"] == name)
    for rank in runs[n]:
        r = rank["cases"][name]
        per, bad = tiers.audit(tier, r)
        assert not bad, bad
        if tier == "program_halo":
            assert r["cg"] == 8 and r["result_gathers"] == 2
            assert r["collectives"]["all_gather_into_tensor"] == 2


@pytest.mark.parametrize("name", ("solve_sharded", "solve_sharded_fused"))
def test_sharded_solves_report_the_world_size(runs, name):
    for n in WORLD:
        for rank in runs[n]:
            assert rank["cases"][name]["num_devices"] == n
            assert rank["cases"][name]["termination"] in ("CONVERGENCE", "NO_CONVERGENCE")


def _gauge_fixed(pkg_bal):
    """A per-block BAL problem with camera 0 and point 3 constant (the
    sentinel columns of the block products)."""
    b = jbal.perturb(jbal.synthetic_bal(num_cameras=4, num_points=25, visibility=0.6,
                                        noise=0.2, seed=2), 0.01, 0.05, 0.05)
    arrays = [a.copy() for a in _arrays(b)]
    if pkg_bal is jbal:
        p, cams, pts = jbal.build_problem(jbal.BALProblem(*arrays))
    else:
        p, cams, pts = pkg_bal.build_problem(pkg_bal.from_arrays(*arrays))
    p.set_parameter_block_constant(cams[0])
    p.set_parameter_block_constant(pts[3])
    return p


@pytest.fixture(scope="module")
def block_products():
    """(JAX (meta, values, x), port (program, meta, values)) at the start."""
    import jax.numpy as jnp
    import torch

    from ceres_tpu.ops import bsr as jbsr

    from ceres_tpu_torch.models import bal as tbal
    from ceres_tpu_torch.ops import bsr as tbsr
    from ceres_tpu_torch.program import CompiledProgram as TProgram

    jprog = CompiledProgram(_gauge_fixed(jbal), sort_rows=True)
    jvals = jprog.evaluate_bsr(jprog.initial_state())[3]
    tprog = TProgram(_gauge_fixed(tbal), device="cpu")
    tvals = tprog.evaluate_bsr(tprog.initial_state())[3]
    rng = np.random.default_rng(0)
    v = rng.standard_normal(tprog.tangent_size)
    u = rng.standard_normal(tprog.num_residuals)
    s = 1.0 + rng.random(tprog.tangent_size)
    return (jbsr, jbsr.build_meta(jprog), jvals, jnp), (tbsr, tbsr.build_meta(tprog), tvals,
                                                        torch), (v, u, s), tprog


@pytest.mark.parametrize("op", ("right_multiply", "left_multiply", "squared_column_norm",
                                "scale_columns"))
def test_block_products_match_jax(block_products, op):
    """ops/bsr.py's J v, J'u, diag(J'J) and J diag(s) against the JAX
    functions (bsr.py:138-208), a constant camera and point included."""
    (jb, jm, jv, jnp), (tb, tm, tv, torch), (v, u, s), _ = block_products
    arg = {"right_multiply": v, "left_multiply": u, "scale_columns": s}.get(op)
    jargs = (jm, jv) + (() if arg is None else (jnp.asarray(arg),))
    targs = (tm, tv) + (() if arg is None else (torch.as_tensor(arg),))
    ref, got = getattr(jb, op)(*jargs), getattr(tb, op)(*targs)
    if op == "scale_columns":
        for rk, gk in zip(ref, got):
            for r, g in zip(rk, gk):
                np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-13, atol=1e-12)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("n", (1, 3))
def test_make_args_shards_add_up_to_the_program(block_products, n):
    """The ranks' make_args shards (padding repeats a kind's last row with
    weight 0 and the sentinel tangent column): their costs plus the fixed
    cost, their J'r and diag(J'J) summed give the whole program's, and
    their J v rows, the padding dropped, the whole J v."""
    (_, _, _, _), (tb, tm, tv, torch), (v, _, _), prog = block_products
    x = prog.initial_state()
    o = prog._eval_core(x)
    cost, g, sqn, jv = prog.fixed_cost, 0.0, 0.0, []
    for rank in range(n):
        args = prog.make_args(pad_to=n, rank=rank)
        shapes = [(a["w"].shape[0], k.r) for a, k in zip(args, prog.kinds)]
        oa = prog._eval_core(x, args=args)
        cost = cost + float(oa["cost"])
        g = g + tb.left_multiply_args(shapes, args, oa["block_jacs"], oa["residuals"],
                                      prog.tangent_size).numpy()
        sqn = sqn + tb.squared_column_norm_args(shapes, args, oa["block_jacs"],
                                                prog.tangent_size).numpy()
        rows = tb.right_multiply_args(shapes, args, oa["block_jacs"], torch.as_tensor(v))
        off = 0
        for a, (B, r) in zip(args, shapes):
            keep = np.repeat(a["w"].numpy() > 0, r)
            jv.append(rows[off:off + B * r].numpy()[keep])
            off += B * r
    assert cost == pytest.approx(float(o["cost"]), rel=1e-14)
    np.testing.assert_allclose(g, prog.gradient(o["block_jacs"], o["residuals"]).numpy(),
                               rtol=1e-13, atol=1e-12)
    np.testing.assert_allclose(sqn, tb.squared_column_norm(tm, tv).numpy(), rtol=1e-13)
    np.testing.assert_allclose(np.concatenate(jv),
                               tb.right_multiply(tm, tv, torch.as_tensor(v)).numpy(),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("n", (2, 3))
def test_make_args_shards_match_jax(block_products, n):
    """Each rank's make_args shard equals rows [r B'/n, (r+1) B'/n) of the
    JAX make_args(pad_to=n) (program.py:531), exactly: each slot's row in
    its family, its tangent columns (the sentinel for a constant block and
    for a padding row), the data and the weight."""
    import jax

    prog = block_products[3]
    ref = CompiledProgram(_gauge_fixed(jbal), sort_rows=True).make_args(pad_to=n)
    for rank in range(n):
        got = prog.make_args(pad_to=n, rank=rank)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            Bp = r["w"].shape[0]
            rows = slice(rank * Bp // n, (rank + 1) * Bp // n)
            np.testing.assert_array_equal(g["w"].numpy(), np.asarray(r["w"])[rows])
            assert len(g["pos"]) == len(r["slots"])
            for gp, gt, rs in zip(g["pos"], g["tangent_idx"], r["slots"]):
                np.testing.assert_array_equal(gp.numpy(), np.asarray(rs["pos_in_family"])[rows])
                np.testing.assert_array_equal(gt.numpy(), np.asarray(rs["tangent_idx"])[rows])
            gl, rl = (jax.tree_util.tree_leaves(t) for t in (g["data"], r["data"]))
            assert len(gl) == len(rl)
            for a, b in zip(gl, rl):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b)[rows])
