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


AUDITED = [c["name"] for c in CASES if c["tier"] in tiers.AUDITED]


@pytest.mark.parametrize("n", WORLD)
@pytest.mark.parametrize("name", AUDITED)
def test_mesh_tier_collectives_within_the_jax_audit(runs, name, n):
    """Each tier's collectives per LM iteration within the bounds of the
    JAX package's audit of its compiled step (tests/test_collective_audit.py,
    tiers.audit): point-sharded no all-to-all, 1-10 all-reduces, no
    all-gather inside the iterations; camera-sharded no all-to-all, 1-2
    all-gathers, at most 8 + 4 cg all-reduces; halo and halo-Ceres no
    all-gather inside the iterations, 1 to 6 + 2 cg all-to-alls of at most
    the cut's rows, no all-reduce of P_pad rows."""
    tier = next(c["tier"] for c in CASES if c["name"] == name)
    for rank in runs[n]:
        r = rank["cases"][name]
        per, bad = tiers.audit(tier, r)
        assert not bad, bad
        if tier != "point":
            assert r["cg"] == 8


@pytest.mark.parametrize("name,breach", [
    ("point", {"all_to_all_single": 1}), ("point", {"all_gather_into_tensor": 1}),
    ("point", {"all_reduce": 40}), ("camera", {"all_gather_into_tensor": 4}),
    ("camera", {"all_reduce": 200}), ("halo", {"all_gather_into_tensor": 1}),
    ("halo", {"all_to_all_single": 60}), ("halo_ceres", {"all_to_all_single": 100})])
def test_audit_flags_a_tier_over_its_bounds(runs, name, breach):
    """tiers.audit on a world size 4 result given extra calls."""
    tier = next(c["tier"] for c in CASES if c["name"] == name)
    r = dict(runs[4][0]["cases"][name])
    r["collectives"] = {k: v + breach.get(k, 0) for k, v in r["collectives"].items()}
    assert tiers.audit(tier, r)[1]


def test_audit_flags_an_exchange_over_the_cut(runs):
    r = dict(runs[4][0]["cases"]["halo"])
    assert r["n"] * r["Hs"] < r["P_pad"]  # the instance has a cut at 4 ranks
    r["largest"] = dict(r["largest"], all_to_all_single=r["P_pad"])
    assert tiers.audit("halo", r)[1]


@pytest.mark.parametrize("n", WORLD)
def test_ranks_report_their_start_and_devices(runs, n):
    """On the CPU: no current card, every tensor a tier returned on the
    CPU, and the rank's start split into spawn to entry and the process
    group (a card's initialization and context only on a card)."""
    for rank in runs[n]:
        assert rank["device"] == "cpu" and rank["current_device"] is None
        assert set(rank["start_seconds"]) == {"spawn_to_entry", "process_group"}
        assert all(v >= 0 for v in rank["start_seconds"].values())
        for name in NAMES:
            assert rank["cases"][name]["devices"] == ["cpu"], name


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


@pytest.mark.parametrize("world_size,backend,device,cards,error,match", [
    (1, "nccl", "cpu", 4, ValueError, "needs the ranks on cards"),
    (2, "nccl", "cuda:0", 4, ValueError, "one card for 2 ranks"),
    (4, "nccl", "cuda", 4, ValueError, "one card for 4 ranks"),
    (4, "nccl", None, 2, ValueError, "4 ranks, 2 cards"),
    (1, "nccl", None, 0, ValueError, "1 ranks, 0 cards"),
    (2, "gloo", None, 0, RuntimeError, "no CUDA device")])
def test_launch_refuses_before_spawning(monkeypatch, world_size, backend, device, cards,
                                        error, match):
    """NCCL takes one rank per card: launch refuses a world size or a
    device that would put two NCCL ranks on one card, or one on the CPU,
    before it spawns any rank."""
    import torch
    import torch_mesh_fns

    def no_spawn(*args, **kwargs):
        raise AssertionError("a rank was spawned")

    monkeypatch.setattr(torch.multiprocessing, "get_context", no_spawn)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    with pytest.raises(error, match=match):
        tmesh.launch(torch_mesh_fns.raising_rank, world_size, backend, device=device)


def _describe_mesh(mesh):
    return str(mesh.device), sorted(mesh.start_seconds)


@pytest.mark.parametrize("backend,device,rank,card", [
    ("nccl", None, 2, 2), ("gloo", None, 3, 3), ("gloo", "cuda:1", 3, 1)])
def test_rank_binds_its_card_before_the_process_group(monkeypatch, tmp_path, backend,
                                                      device, rank, card):
    """A rank makes its card current (device=None: rank r card r % the
    cards) before init_process_group, and under NCCL passes it as
    device_id, so that the communicator is built there at once. The rank
    runs in this process here, torch.cuda and the process group stubbed."""
    import pickle
    import time
    import types

    import torch

    events, results = [], []
    cuda = {"is_available": lambda: True, "device_count": lambda: 4,
            "init": lambda: events.append("init"),
            "set_device": lambda d: events.append(("set_device", torch.device(d))),
            "synchronize": lambda d=None: events.append(("synchronize", d))}
    for name, fn in cuda.items():
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(tmesh.dist, "init_process_group", lambda *a, **k: events.append(
        ("init_process_group", a[0], k["device_id"])))
    monkeypatch.setattr(tmesh.dist, "destroy_process_group", lambda: events.append("destroy"))
    monkeypatch.setattr(tmesh, "make_mesh", lambda device: types.SimpleNamespace(
        device=device))
    queue = types.SimpleNamespace(put=results.append)
    call = tmp_path / "call.pkl"
    call.write_bytes(pickle.dumps((_describe_mesh, ())))
    tmesh._rank_main(str(call), rank, 4, backend, device, "file:///unused", 10, queue,
                     time.time())
    dev = torch.device("cuda", card)
    assert results == [(rank, "ok", (str(dev), ["context", "cuda_init", "process_group",
                                                  "spawn_to_entry"]))]
    assert events == ["init", ("set_device", dev), ("synchronize", dev),
                      ("init_process_group", backend, dev if backend == "nccl" else None),
                      "destroy"]
