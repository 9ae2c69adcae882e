"""The port's multi-device BA tiers (ceres_tpu_torch/parallel/sharded_ba.py)
against the JAX package's, on the CPU: world sizes 1, 2 and 4 over gloo,
each rank a spawned process (parallel.mesh.launch), at the JAX tests'
sizes (tests/test_sharding.py): solve_ba with a mesh (its CG and Schur
steps), the point-sharded tier, the camera-sharded tier, the halo tier and
the Ceres-semantics halo tier; the three plans array for array; the
launcher's failures.

Every world size runs every case from one module-scoped launch of four
ranks: world size 4 over all of them, 2 and 1 over subgroups. Each case
runs twice (tiers.run_cases says whether the repeat gave the same bits);
the parametrized tests read the results. Where the JAX tier's own test is in the fast tier (camera,
halo, halo-Ceres), the reference is the JAX sharded function on the
8-device CPU mesh; elsewhere the JAX unsharded function, which the JAX
slow tests hold to the sharded one at 1e-10. Tolerances as
tests/test_sharding.py's: the cost 1e-10 relative, the state 1e-8
relative to its largest entry with 1e-10 absolute; the halo-Ceres CG
budget pinned (eta = 1e-30, 8 iterations), as tests/test_sharding.py:441
pins it, so that summation order cannot branch the trajectory."""
import jax.numpy as jnp
import numpy as np
import pytest

from ceres_tpu.models import bal as jbal
from ceres_tpu.parallel import sharded_ba as jsb

from ceres_tpu_torch.parallel import mesh as tmesh
from ceres_tpu_torch.parallel import sharded_ba as tsb
from ceres_tpu_torch.parallel import tiers

WORLD = (1, 2, 4)
PIN = dict(eta=1e-30, max_linear_solver_iterations=8)
DEADLINE_S = 240


def _arrays(b):
    return (np.asarray(b.cameras, np.float64), np.asarray(b.points, np.float64),
            np.asarray(b.camera_index), np.asarray(b.point_index),
            np.asarray(b.observations, np.float64))


def _camera_problem():
    """tests/test_sharding.py:295's instance."""
    return jbal.perturb(jbal.synthetic_bal(num_cameras=24, num_points=300, visibility=0.2,
                                           noise=0.3, seed=11), 0.02, 0.1, 0.1)


def _point_problem():
    """tests/test_sharding.py:239's instance."""
    b = jbal.synthetic_bal(num_cameras=5, num_points=97, visibility=0.4, noise=0.5, seed=7)
    return jbal.perturb(b, rotation_sigma=0.01, translation_sigma=0.1, point_sigma=0.1,
                        seed=8)


PROBLEMS = {"cam": _arrays(_camera_problem()), "pt": _arrays(_point_problem())}
CASES = [
    dict(name="solve_ba_cg", tier="solve_ba", problem="cam", num_iterations=3, step="cg",
         cg_iters=8),
    dict(name="solve_ba_schur", tier="solve_ba", problem="pt", num_iterations=3,
         step="schur"),
    dict(name="point", tier="point", problem="pt", num_iterations=4, k=4),
    dict(name="camera", tier="camera", problem="cam", num_iterations=3, k=1, cg_iters=8),
    dict(name="halo", tier="halo", problem="cam", num_iterations=3, k=1, cg_iters=8),
    dict(name="halo_ceres", tier="halo_ceres", problem="cam", k=4, max_num_iterations=6,
         options=PIN),
]
NAMES = [c["name"] for c in CASES]


def _bal(name):
    return jbal.BALProblem(*(a.copy() for a in PROBLEMS[name]))


def _jax_reference(case):
    """(cost, cams, pts) of the JAX counterpart."""
    name = case["name"]
    if name.startswith("solve_ba"):
        st = jsb.solve_ba(_bal(case["problem"]), case["num_iterations"], mesh=None,
                          cg_iters=case.get("cg_iters", 10), step=case["step"])
        return float(st.cost), np.asarray(st.cams), np.asarray(st.pts)
    if name == "point":
        cams, pts, ci, pi, obs = PROBLEMS["pt"]
        o = np.argsort(pi, kind="stable")
        st = jsb.lm_step_schur_k(jnp.asarray(cams), jnp.asarray(pts), jnp.asarray(ci[o]),
                                 jnp.asarray(pi[o]), jnp.asarray(obs[o]),
                                 jnp.asarray(1e4, jnp.float64), k=case["k"])
        return float(st.cost), np.asarray(st.cams), np.asarray(st.pts)
    mesh = jsb.make_mesh(8, axis="cam")
    if name == "halo_ceres":
        st, plan, _ = jsb.solve_ba_camera_halo_ceres(
            _bal("cam"), jsb.ShardedLMOptions(**PIN), mesh=mesh, k=case["k"],
            max_num_iterations=case["max_num_iterations"])
    else:
        st, plan = jsb.solve_ba_camera_sharded(_bal("cam"), case["num_iterations"], mesh=mesh,
                                               k=1, cg_iters=8, halo=name == "halo")
    return (float(st.cost), np.asarray(st.cams)[plan.camera_slot],
            np.asarray(st.pts)[plan.point_slot])


@pytest.fixture(scope="module")
def _launched():
    """(runs, jax_refs): one launch of four ranks, world size 4 over all
    of them, then 2 and 1 over subgroups side by side
    (tiers.run_world_sizes), so that the ranks start once; the JAX
    references are computed here while the ranks run."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(tmesh.launch, tiers.run_world_sizes, max(WORLD), "gloo", "cpu",
                        DEADLINE_S, (PROBLEMS, CASES, WORLD))
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
def test_mesh_tier_matches_jax(runs, jax_refs, name, n):
    cost, cams, pts = jax_refs[name]
    for rank in runs[n]:
        r = rank["cases"][name]
        assert r["cost"] == pytest.approx(cost, rel=1e-10)
        _close(r["cams"], cams, 1e-8, 1e-10)
        _close(r["pts"], pts, 1e-8, 1e-10)
    # every rank holds the same answer, bit for bit
    first = runs[n][0]["cases"][name]
    for rank in runs[n][1:]:
        r = rank["cases"][name]
        assert r["cost"] == first["cost"]
        assert np.array_equal(r["cams"], first["cams"]) and np.array_equal(r["pts"],
                                                                            first["pts"])


@pytest.mark.parametrize("n", WORLD)
@pytest.mark.parametrize("name", NAMES)
def test_mesh_tier_repeats_bit_for_bit(runs, name, n):
    for rank in runs[n]:
        assert rank["cases"][name]["repeat_bitwise"]


@pytest.mark.parametrize("name", NAMES)
def test_mesh_world_sizes_agree(runs, name):
    base = runs[1][0]["cases"][name]
    for n in WORLD[1:]:
        r = runs[n][0]["cases"][name]
        assert r["cost"] == pytest.approx(base["cost"], rel=1e-10)
        _close(r["cams"], base["cams"], 1e-8, 1e-10)
        _close(r["pts"], base["pts"], 1e-8, 1e-10)


@pytest.mark.parametrize("n", WORLD)
def test_point_sharded_runs_rows_6_7_8j_on_every_rank(runs, n):
    """Each rank's point sums, gathers and A spread go through the plain
    versions of segment_block_sum, segment_block_expand and
    segment_spread_ftf here (their kernels on a card), over its own plan;
    the state stays partitioned (each rank Pl points)."""
    for rank in runs[n]:
        r = rank["cases"]["point"]
        for name in ("segment_block_sum", "segment_block_expand", "segment_spread_ftf"):
            assert r["plain_calls"].get(name, 0) > 0, (name, r["plain_calls"])
        assert r["local_rows"] == r["Pl"]
        if n > 1:
            assert r["collectives"]["all_reduce"] > 0


@pytest.mark.parametrize("n", WORLD[1:])
def test_camera_tiers_exchange_what_they_should(runs, n):
    """The camera-sharded tier gathers the point table; the halo tier
    exchanges the cut by all-to-alls and never gathers."""
    for rank in runs[n]:
        cam, halo = rank["cases"]["camera"], rank["cases"]["halo"]
        assert cam["plan"] == "CameraShardPlan" and cam["collectives"][
            "all_gather_into_tensor"] > 0
        assert halo["plan"] == "CameraHaloPlan" and halo["collectives"][
            "all_to_all_single"] > 0
        assert halo["collectives"]["all_gather_into_tensor"] == 2  # the result's tables


@pytest.mark.parametrize("n", (2, 4, 8))
def test_plan_point_sharding_matches_jax(n):
    b = _point_problem()
    args = (b.camera_index, b.point_index, b.points, b.observations, n)
    _same_plan(tsb.plan_point_sharding(*args), jsb.plan_point_sharding(*args))


@pytest.mark.parametrize("n", (2, 4, 8))
def test_plan_camera_sharding_matches_jax(n):
    b = _camera_problem()
    args = (b.camera_index, b.point_index, b.cameras, b.points, b.observations, n)
    _same_plan(tsb.plan_camera_sharding(*args), jsb.plan_camera_sharding(*args))


@pytest.mark.parametrize("n", (2, 4, 8))
def test_plan_camera_halo_matches_jax(n):
    b = _camera_problem()
    args = (b.camera_index, b.point_index, b.cameras, b.points, b.observations, n)
    _same_plan(tsb.plan_camera_halo(*args), jsb.plan_camera_halo(*args))


def _same_plan(got, ref):
    assert got._fields == ref._fields
    for f in ref._fields:
        a, b = getattr(got, f), getattr(ref, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f


def test_launch_fails_when_a_rank_raises():
    import torch_mesh_fns

    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        tmesh.launch(torch_mesh_fns.raising_rank, 2, "gloo", device="cpu",
                     timeout_s=DEADLINE_S)


def test_launch_fails_when_a_rank_never_joins():
    import time

    import torch_mesh_fns

    t0 = time.monotonic()
    # the launcher's deadline, or the waiting rank's collective timing out
    # (both are the deadline given), whichever comes first
    with pytest.raises((TimeoutError, RuntimeError)):
        tmesh.launch(torch_mesh_fns.stuck_rank, 2, "gloo", device="cpu", timeout_s=6)
    assert time.monotonic() - t0 < 20


def test_launch_takes_only_named_backends():
    with pytest.raises(ValueError, match="backend"):
        tmesh.launch(tiers.run_cases, 1, "mpi", device="cpu")
