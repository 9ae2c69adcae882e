"""ceres_tpu_torch.parallel.sharded_ba against ceres_tpu.parallel.sharded_ba
on the CPU: the exact dense-Schur LM step with and without the point plan
(the plain versions of kernels 6, 7 and 8J), its k-iteration carry, the v2
pipeline through the plain Schur assembly, the CGNR step and solve_ba, on
the same numpy inputs (rows sorted by point). Tolerances, relative to the
largest entry of the JAX result: 1e-10 in float64 (sums in another order);
1e-9 for v2 against JAX v1 (the same math, the assembly's sums in another
order still); float32 as tests/test_sharding.py:183-185 holds the Pallas
plan against the scatter path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceres_tpu.models import bal as jbal
from ceres_tpu.parallel import sharded_ba as jsb

from ceres_tpu_torch.ops import kernels as kn
from ceres_tpu_torch.parallel import sharded_ba as tsb

K = 6
PAD = 5


def _problem():
    """tests/test_sharding.py:194's instance, rows sorted by point."""
    b = jbal.perturb(jbal.synthetic_bal(num_cameras=6, num_points=80, visibility=0.4,
                                        noise=0.3, seed=5), 0.02, 0.1, 0.1, seed=6)
    order = np.argsort(b.point_index, kind="stable")
    return (np.asarray(b.cameras), np.asarray(b.points), b.camera_index[order],
            b.point_index[order], np.asarray(b.observations)[order])


def _padded(arrays):
    """PAD rows of the last point and camera 0 at the end, far-off pixels,
    masked by w (tests/test_sharding.py:147-157, kept sorted by point)."""
    cams, pts, ci, pi, obs = arrays
    P, B = pts.shape[0], ci.shape[0]
    w = np.concatenate([np.ones(B), np.zeros(PAD)])
    return (cams, pts, np.concatenate([ci, np.zeros(PAD, ci.dtype)]),
            np.concatenate([pi, np.full(PAD, P - 1, pi.dtype)]),
            np.concatenate([obs, np.full((PAD, 2), 1e6)]), w)


def _jax_args(arrays, dtype=jnp.float64):
    cams, pts, ci, pi, obs = arrays[:5]
    return (jnp.asarray(cams, dtype), jnp.asarray(pts, dtype), jnp.asarray(ci),
            jnp.asarray(pi), jnp.asarray(obs, dtype))


def _torch_args(arrays, dtype=torch.float64):
    cams, pts, ci, pi, obs = arrays[:5]
    st = tsb.state_from_arrays(cams, pts, 1e4, dtype, device="cpu")
    return (st.cams, st.pts, torch.as_tensor(ci), torch.as_tensor(pi),
            torch.as_tensor(obs, dtype=dtype)), st.radius


def _plan(arrays):
    cams, pts, ci, pi = arrays[:4]
    return tsb.build_point_plan(ci, pi, pts.shape[0], cams.shape[0], device="cpu")


def _assert_state(out, ref, tol):
    for name in ("cams", "pts", "radius", "cost"):
        o = getattr(out, name).double().numpy()
        r = np.asarray(getattr(ref, name), np.float64)
        err = np.abs(o - r).max() / max(np.abs(r).max(), 1e-300)
        assert err <= tol, (name, err)


@pytest.fixture(scope="module")
def arrays():
    return _problem()


@pytest.fixture(scope="module")
def jax_step(arrays):
    return jax.jit(jsb.lm_step_schur)(*_jax_args(arrays), jnp.asarray(1e4))


@pytest.fixture(scope="module")
def jax_k(arrays):
    return jax.jit(lambda *a: jsb.lm_step_schur_k(*a, k=K))(*_jax_args(arrays),
                                                              jnp.asarray(1e4))


@pytest.mark.parametrize("with_plan", [False, True])
def test_lm_step_schur_matches_jax(arrays, jax_step, with_plan):
    args, radius = _torch_args(arrays)
    kn.reset_counts()
    out = tsb.lm_step_schur(*args, radius, plan=_plan(arrays) if with_plan else None)
    _assert_state(out, jax_step, 1e-10)
    spread = kn.segment_spread_ftf.plain_calls
    assert spread == (1 if with_plan else 0)
    assert (kn.segment_block_sum.plain_calls > 0) == with_plan
    assert (kn.segment_block_expand.plain_calls > 0) == with_plan


@pytest.mark.parametrize("with_plan", [False, True])
def test_lm_step_schur_padded_rows_match_jax(arrays, jax_step, with_plan):
    """Masked padding rows add nothing, in A, in F'F or in the cost: the
    padded step matches JAX's padded step and the unpadded one."""
    padded = _padded(arrays)
    w = padded[5]
    ref = jax.jit(jsb.lm_step_schur)(*_jax_args(padded), jnp.asarray(1e4),
                                     jnp.asarray(w))
    args, radius = _torch_args(padded)
    out = tsb.lm_step_schur(*args, radius, w=torch.as_tensor(w),
                            plan=_plan(padded) if with_plan else None)
    _assert_state(out, ref, 1e-10)
    _assert_state(out, jax_step, 1e-9)


@pytest.mark.parametrize("with_plan", [False, True])
def test_lm_step_schur_rejects_a_failed_factor_as_jax(arrays, with_plan):
    """A negative radius makes D^2 negative and the factors fail: they come
    out NaN (cholesky_ex, no raise and no host sync) and the step is
    rejected, state kept and radius halved, as JAX's NaN Cholesky does."""
    ref = jax.jit(jsb.lm_step_schur)(*_jax_args(arrays), jnp.asarray(-1e-3))
    args, _ = _torch_args(arrays)
    out = tsb.lm_step_schur(*args, torch.tensor(-1e-3, dtype=torch.float64),
                            plan=_plan(arrays) if with_plan else None)
    _assert_state(out, ref, 1e-10)
    assert torch.equal(out.cams, args[0]) and torch.equal(out.pts, args[1])
    assert float(out.radius) == -5e-4


@pytest.mark.parametrize("with_plan", [False, True])
def test_lm_step_schur_k_matches_jax(arrays, jax_k, with_plan):
    args, radius = _torch_args(arrays)
    kn.reset_counts()
    out = tsb.lm_step_schur_k(*args, radius, k=K,
                              plan=_plan(arrays) if with_plan else None)
    _assert_state(out, jax_k, 1e-10)
    # one spread per LM iteration: the k-call's one evaluation carry
    assert kn.segment_spread_ftf.plain_calls == (K if with_plan else 0)


def test_lm_step_schur_k_init_next_match_k(arrays):
    """init, then k nexts, is lm_step_schur_k, bit for bit."""
    args, radius = _torch_args(arrays)
    plan = _plan(arrays)
    carry = tsb.lm_step_schur_init(*args, radius, plan=plan)
    for _ in range(3):
        carry = tsb.lm_step_schur_next(carry, *args[2:], plan=plan)
    out = tsb.lm_step_schur_k(*args, radius, k=3, plan=plan)
    assert torch.equal(carry.cams, out.cams) and torch.equal(carry.cost, out.cost)


def test_lm_step_schur_v2_k_matches_jax_v1(arrays, jax_k):
    """v2 (the plain Schur assembly, kernels 3, 6 and 7) against JAX's v1,
    the same math (JAX's own v2 runs only as interpret-mode Pallas)."""
    cams, pts, ci, pi, obs = arrays
    args, radius = _torch_args(arrays)
    plan = tsb.build_asm_plan(ci, pi, pts.shape[0], cams.shape[0], device="cpu")
    kn.reset_counts()
    out = tsb.lm_step_schur_v2_k(args[0], args[1], args[2], args[3],
                                 args[4].T.contiguous(), radius, plan, k=K)
    _assert_state(out, jax_k, 1e-9)
    assert kn.schur_assembly.plain_calls == K
    assert kn.segment_spread_ftf.plain_calls == 0
    assert kn.segment_block_sum.plain_calls == 2 * K
    with pytest.raises(ValueError, match="needs a plan"):
        tsb.lm_step_schur_v2_k(args[0], args[1], args[2], args[3],
                               args[4].T.contiguous(), radius, None, k=1)


@pytest.mark.parametrize("padded", [False, True])
def test_lm_step_cgnr_matches_jax(arrays, padded):
    """The CGNR step, also with masked padding rows (which then add
    nothing to the sums or the cost)."""
    inputs = _padded(arrays) if padded else arrays
    w = inputs[5] if padded else None
    jw = None if w is None else jnp.asarray(w)
    ref = jax.jit(lambda *a: jsb.lm_step(*a, w=jw, cg_iters=10))(
        *_jax_args(inputs), jnp.asarray(1e4))
    args, radius = _torch_args(inputs)
    out = tsb.lm_step(*args, radius, w=None if w is None else torch.as_tensor(w),
                      cg_iters=10)
    _assert_state(out, ref, 1e-10)


@pytest.mark.parametrize("step", ["cg", "schur", "auto"])
def test_solve_ba_matches_jax(step):
    """solve_ba without a mesh, three LM iterations, against JAX's."""
    b = jbal.perturb(jbal.synthetic_bal(num_cameras=4, num_points=33, visibility=0.5,
                                        noise=0.3, seed=9), 0.02, 0.1, 0.1)
    ref = jsb.solve_ba(b, num_iterations=3, mesh=None, cg_iters=5, step=step)
    out = tsb.solve_ba(b, num_iterations=3, cg_iters=5, step=step, device="cpu")
    _assert_state(out, ref, 1e-10)
    assert out.cams.device.type == "cpu" and out.cams.dtype == torch.float64


def test_lm_step_schur_float32_plan_matches_jax_scatter(arrays):
    """float32 through the plain kernels 6, 7 and 8J against JAX's float32
    scatter path, as tests/test_sharding.py:183-185 holds JAX's own Pallas
    plan: cost to 1e-3 relative, cameras to rtol 1e-2, atol 1e-4."""
    ref = jax.jit(jsb.lm_step_schur)(*_jax_args(arrays, jnp.float32), jnp.float32(1e4))
    args, radius = _torch_args(arrays, torch.float32)
    out = tsb.lm_step_schur(*args, radius, plan=_plan(arrays))
    assert out.cost.dtype == out.cams.dtype == torch.float32
    assert abs(float(out.cost) - float(ref.cost)) < 1e-3 * float(ref.cost)
    np.testing.assert_allclose(out.cams.numpy(), np.asarray(ref.cams), rtol=1e-2,
                               atol=1e-4)


def _spy_dtypes(monkeypatch, target):
    """The dtypes tsb.<target> is called with, from now on."""
    seen = []
    inner = getattr(tsb, target)

    def spy(m):
        seen.append(m.dtype)
        return inner(m)

    monkeypatch.setattr(tsb, target, spy)
    return seen


def test_precision_flags_are_read_at_call_time(arrays, monkeypatch):
    """In float32 the 9C x 9C Cholesky runs in float64 only with
    PRECISE_SCHUR_SOLVE, off by default as in the JAX module; the state
    stays float32 either way."""
    assert tsb.PRECISE_SCHUR_SOLVE is False
    seen = _spy_dtypes(monkeypatch, "cholesky_lower")
    args, radius = _torch_args(arrays, torch.float32)
    for value in (False, True):
        monkeypatch.setattr(tsb, "PRECISE_SCHUR_SOLVE", value)
        out = tsb.lm_step_schur(*args, radius, plan=_plan(arrays))
        assert out.cams.dtype == out.cost.dtype == torch.float32
        assert torch.isfinite(out.cost)
    assert seen == [torch.float32, torch.float64]


@pytest.mark.parametrize("pipeline", ["v1", "v2"])
def test_point_solves_run_in_float64(arrays, monkeypatch, pipeline):
    """In float32 both pipelines factor the per-point 3x3 blocks in
    float64 (the JAX module's PRECISE_POINT_SOLVES, on) and keep the state
    in float32."""
    seen = _spy_dtypes(monkeypatch, "_chol3_flat")
    cams, pts, ci, pi, obs = arrays
    args, radius = _torch_args(arrays, torch.float32)
    if pipeline == "v1":
        out = tsb.lm_step_schur_k(*args, radius, k=2, plan=_plan(arrays))
    else:
        plan = tsb.build_asm_plan(ci, pi, pts.shape[0], cams.shape[0], device="cpu")
        out = tsb.lm_step_schur_v2_k(*args[:4], args[4].T.contiguous(), radius, plan,
                                     k=2)
    assert out.cams.dtype == out.cost.dtype == torch.float32
    assert torch.isfinite(out.cost)
    assert seen == [torch.float64] * 2


def test_entry_points_need_a_card_or_the_cpu(monkeypatch):
    """solve_ba and the plan builders run on the card unless asked for the
    CPU, and raise without one; a mesh needs an initialized process group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = jbal.synthetic_bal(num_cameras=3, num_points=20, visibility=0.6, seed=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsb.solve_ba(b, num_iterations=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsb.build_point_plan(b.camera_index, b.point_index, 20, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsb.state_from_arrays(b.cameras, b.points, 1e4, torch.float64)
    from ceres_tpu_torch.parallel import mesh

    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_mesh(device="cpu")


def test_observations_by_point_sorts_stably():
    b = jbal.synthetic_bal(num_cameras=3, num_points=20, visibility=0.6, seed=2)
    rng = np.random.default_rng(0)
    perm = rng.permutation(b.num_observations)
    ci, pi, obs = tsb.observations_by_point(b.camera_index[perm], b.point_index[perm],
                                            b.observations[perm], torch.float32, "cpu")
    order = np.argsort(b.point_index[perm], kind="stable")
    assert ci.dtype == pi.dtype == torch.int32 and obs.dtype == torch.float32
    np.testing.assert_array_equal(pi.numpy(), b.point_index[perm][order])
    np.testing.assert_array_equal(ci.numpy(), b.camera_index[perm][order])
    np.testing.assert_array_equal(obs.numpy(), b.observations[perm][order].astype(np.float32))


@pytest.mark.parametrize("pipeline", ["v1", "v2"])
def test_kernel_calls_are_those_chip_smoke_checks(arrays, pipeline):
    """chip_smoke.py checks and times each kernel call of a k-call's first
    iteration at its own inputs (SPECIALIZED_CASES) and holds a k-call's
    launches to specialized_launches: the pipelines make exactly those
    calls, in that order, and the wrappers come back after the catch."""
    import chip_smoke

    cams, pts, ci, pi, obs = arrays
    args, radius = _torch_args(arrays)
    if pipeline == "v1":
        plan = _plan(arrays)

        def run(st, k):
            return tsb.lm_step_schur_k(st.cams, st.pts, *args[2:], st.radius, k=k, plan=plan)
    else:
        plan = tsb.build_asm_plan(ci, pi, pts.shape[0], cams.shape[0], device="cpu")
        obs_T = args[4].T.contiguous()

        def run(st, k):
            return tsb.lm_step_schur_v2_k(st.cams, st.pts, args[2], args[3], obs_T,
                                          st.radius, plan, k=k)

    wrappers = {k.__name__: k for k in kn.KERNELS}
    start = tsb.BAState(args[0], args[1], radius, torch.zeros((), dtype=torch.float64))
    caught = chip_smoke.first_iteration_args(pipeline, run, start)
    assert list(caught) == [c for c, _, _ in chip_smoke.SPECIALIZED_CASES[pipeline]]
    assert all(getattr(kn, n) is f for n, f in wrappers.items())
    for case, case_args in caught.items():
        out = wrappers[chip_smoke.CASES[case]](*case_args)
        assert all(torch.isfinite(o).all() for o in chip_smoke.as_tuple(out)), case
    kn.reset_counts()
    run(start, K)
    want = chip_smoke.specialized_launches(pipeline, K)
    assert {n: f.plain_calls for n, f in wrappers.items()} == {
        n: want.get(n, 0) for n in wrappers}
