"""The ITERATIVE_SCHUR slice of ceres_tpu_torch against ceres_tpu on the
same inputs, on the CPU (the kernels' plain versions): the implicit Schur
product and the Schur-Jacobi blocks, the conjugate gradients, the
Venice-shaped generator and the whole solve. float64 unless a test says
otherwise; each tolerance is stated where it is used."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu.models import bal as jbal
from ceres_tpu.ops import bsr as jbsr
from ceres_tpu.ops import pallas_kernels as pk
from ceres_tpu.ops import partition as jpt
from ceres_tpu.ops.flatops import FlatSchurOps as JaxFlatSchurOps
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers.linear import cg as jcg
from ceres_tpu.solvers.linear.implicit_schur import build_schur_system
from ceres_tpu.utils import ordering as jord

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.ops import flatops as fo
from ceres_tpu_torch.ops import kernels as kn
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.solvers.fused_lm import DenseSchurStepOps, IterativeSchurStepOps
from ceres_tpu_torch.solvers.linear import cg as tcg

IS = ctt.LinearSolverType.ITERATIVE_SCHUR


def small_bal():
    b = jbal.synthetic_bal(num_cameras=4, num_points=300, visibility=0.5, seed=0)
    return jbal.perturb(b, 0.01, 0.05, 0.05, seed=1)


def port_problem(b):
    return tbal.build_problem_batched(tbal.from_arrays(
        b.cameras, b.points, b.camera_index, b.point_index, b.observations))


def rel_err(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def schur_setup():
    """The JAX flat Schur operations on the unscaled Jacobian of the
    small problem, and the port's step adapter on the same problem."""
    b = jbal.perturb(jbal.synthetic_bal(num_cameras=8, num_points=80,
                                        visibility=0.4, noise=0.1, seed=0),
                     0.01, 0.05, 0.05, seed=1)
    jprog = JaxProgram(jbal.build_problem_batched(b)[0])
    meta = jbsr.build_meta(jprog)
    o = jprog._eval_core(jprog.initial_state(), True, False)
    pm = jpt.build_partition(meta, jord.eligible_e_sets(jprog))
    jfo = JaxFlatSchurOps(pm)
    vflat = jfo.flatten(o["block_jacs"])
    D = jnp.linspace(0.5, 2.0, meta.tangent_size)
    D_e, D_f = jpt.extract_e(pm, D), jpt.extract_f(pm, D)
    sys_ = build_schur_system(pm, o["block_jacs"], o["residuals"], D_e)
    minvf = jfo.minv_flatten(sys_.ete_factors)
    prog = CompiledProgram(port_problem(b)[0], "float64", device="cpu")
    ops = IterativeSchurStepOps(prog, ctt.Options(linear_solver_type=IS), [1])
    _, vrep = ops.evaluate(prog.initial_state())
    return dict(jfo=jfo, vflat=vflat, D_f=D_f, minvf=minvf, ops=ops,
                JT=vrep.jt, vrep=vrep, C=b.num_cameras, P=b.num_points)


def test_isc_matvec_plain_matches_jax_schur_multiply(schur_setup):
    """S z without its D_f^2 term, and u = Minv E'F z, against the JAX flat
    chain (flatops.py:806) on the same Jacobian and M^{-1}: 1e-10
    relative (the two Jacobians differ in the rotation's branch-free form
    by ~1e-13 relative)."""
    s = schur_setup
    C, P = s["C"], s["P"]
    z = np.random.default_rng(3).standard_normal(C * 9)
    jfo, vflat, D_f = s["jfo"], s["vflat"], s["D_f"]
    ref = np.asarray(jfo.schur_multiply(vflat, s["minvf"], D_f, jnp.asarray(z)))
    ref = ref - np.asarray(D_f * D_f) * z
    u_ref = np.asarray(jfo.minv_apply(
        s["minvf"], jfo.left_e(vflat, jfo.right_f(vflat, jnp.asarray(z)))))
    minv = torch.as_tensor(np.array(s["minvf"][0]))
    cam, u = kn.isc_matvec_plain(s["JT"], torch.as_tensor(z).reshape(C, 9), minv,
                                 s["ops"].flat.plan, emit_u=True)
    assert rel_err(cam.reshape(-1), ref) <= 1e-10
    assert rel_err(u.reshape(-1), u_ref) <= 1e-10
    _, no_u = kn.isc_matvec_plain(s["JT"], torch.as_tensor(z).reshape(C, 9), minv,
                                  s["ops"].flat.plan)
    assert no_u is None


def test_kernel_suite_folds_the_jacobi_scales(schur_setup):
    """The suite's scale-folded matvec and Schur-Jacobi inverses equal the
    plain functions on an explicitly scaled Jacobian: 1e-12 relative."""
    s = schur_setup
    C, P, ops = s["C"], s["P"], s["ops"]
    rng = np.random.default_rng(4)
    se = torch.as_tensor(rng.uniform(0.5, 1.5, P * 3))
    sf = torch.as_tensor(rng.uniform(0.5, 1.5, C * 9))
    d2f = torch.as_tensor(rng.uniform(0.5, 1.5, C * 9))
    minv = torch.as_tensor(np.array(s["minvf"][0]))
    matvec, jacobi_blocks, _, fold_minv = ops.flat.make_kernel_suite_raw(
        s["JT"], se, sf)
    JTs = s["JT"].clone()
    JTs[:18] *= sf.reshape(C, 9).T[torch.arange(18) % 9][:, ops.flat.plan.cam_idx.long()]
    JTs[18:] *= se.reshape(P, 3).T[torch.arange(6) % 3][:, ops.flat.plan.pt_idx.long()]
    z = torch.as_tensor(rng.standard_normal(C * 9))
    cam, u = matvec(z, fold_minv(minv), emit_u=True)
    cam_ref, u_ref = kn.isc_matvec_plain(JTs, z.reshape(C, 9), minv,
                                         ops.flat.plan, emit_u=True)
    assert rel_err(cam, cam_ref.reshape(-1)) <= 1e-12
    assert rel_err(u, u_ref.reshape(-1)) <= 1e-12
    # with unit point scales minv is the point blocks' own M^{-1}, so the
    # camera blocks of the Schur complement are positive definite
    ones = torch.ones(P * 3, dtype=JTs.dtype)
    jacobi_blocks = ops.flat.make_kernel_suite_raw(s["JT"], ones, sf)[1]
    JTs = s["JT"].clone()
    JTs[:18] *= sf.reshape(C, 9).T[torch.arange(18) % 9][:, ops.flat.plan.cam_idx.long()]
    blocks = kn.schur_jacobi_blocks_plain(JTs, ones.reshape(P, 3), minv,
                                          ops.flat.plan)
    M = blocks + torch.diag_embed(d2f.reshape(C, 9)).reshape(C, 81)
    inv_ref = torch.linalg.inv(M.reshape(C, 9, 9)).reshape(C, 81)
    assert rel_err(jacobi_blocks(minv, d2f), inv_ref) <= 1e-10


def _port_plan_and_jt(Jf, Je, pt, cam, P, C):
    plan = fo.build_row_plan(pt, cam, P, C, "cpu", n_cams=C)
    B = pt.shape[0]
    JT = np.concatenate([Jf.transpose(1, 2, 0).reshape(18, B),
                         Je.transpose(1, 2, 0).reshape(6, B)])
    return plan, torch.as_tensor(JT.astype(np.float64))


def test_schur_jacobi_blocks_plain_matches_sj_assembly_windowed():
    """Against the camera-windowed Pallas kernel in interpret mode, at the
    BA shape of tests/test_pallas_kernels.py:473 (260 cameras, past one
    128-camera window), with point scales as the kernel's sp slot: the
    kernel runs in float32, so rtol 2e-4, atol 5e-4 as there."""
    P, C, B, r, tf, te = 300, 260, 2000, 2, 9, 3
    rng = np.random.default_rng(P + 3 * C)
    pt = np.sort(rng.integers(0, P, B)).astype(np.int32)
    cam = np.clip((pt.astype(np.int64) * C) // P + rng.integers(-20, 20, B),
                  0, C - 1).astype(np.int32)
    Jf = rng.standard_normal((B, r, tf)).astype(np.float32)
    Je = rng.standard_normal((B, r, te)).astype(np.float32)
    se = rng.uniform(0.5, 1.5, (P, te)).astype(np.float32)
    minv = rng.standard_normal((P, te * te)).astype(np.float32)
    ts, tb, max_rows = pk.plan_row_tiles(pt, P + 1, target_rows=256)
    windows = pk.plan_camera_windows(pt, cam, np.asarray(tb), P, C, width_cap=256)
    JT, ids_T = pk.prep_matvec_rows(
        jnp.asarray(Jf.reshape(B, -1)), jnp.asarray(Je.reshape(B, -1)),
        jnp.asarray(pt), jnp.asarray(cam), max_rows, r, tf, te)
    gf = max(8, -(-tf // 8) * 8)
    pw = jnp.zeros((P + 1 + pk.BLOCKS_PER_TILE, 128), jnp.float32)
    pw = pw.at[:P, :te].set(jnp.asarray(se))
    pw = pw.at[:P, 8:8 + te * te].set(jnp.asarray(minv))
    out = pk.sj_assembly_windowed(JT, ids_T, pw, jnp.asarray(ts), jnp.asarray(tb),
                                  windows, P, C, r, tf, te, max_rows=max_rows,
                                  interpret=True)
    ref = np.asarray(out)[:C].reshape(C, tf, gf)[:, :, :tf]
    plan, JTt = _port_plan_and_jt(Jf, Je, pt, cam, P, C)
    got = kn.schur_jacobi_blocks_plain(JTt, torch.as_tensor(se.astype(np.float64)),
                                       torch.as_tensor(minv.astype(np.float64)), plan)
    np.testing.assert_allclose(got.reshape(C, tf, tf).numpy(), ref, rtol=2e-4,
                               atol=5e-4)


def test_schur_jacobi_blocks_plain_matches_schur_assembly_sj_mode():
    """Against the small-C Pallas assembly in mode="schur_jacobi"
    (interpret mode, 7 cameras): it returns (corr, FtF) with the camera
    scales applied inside, here ones; the kernel runs in float32, so rtol
    5e-4, atol 5e-3 as in tests/test_pallas_kernels.py:335."""
    P, C, B, r, tf, te = 150, 7, 900, 2, 9, 3
    rng = np.random.default_rng(P * 3 + C)
    pt = np.sort(rng.integers(0, P, B)).astype(np.int32)
    cam = rng.integers(0, C, B).astype(np.int32)
    Jf = rng.standard_normal((B, r, tf)).astype(np.float32)
    Je = rng.standard_normal((B, r, te)).astype(np.float32)
    se = rng.uniform(0.5, 1.5, (P, te)).astype(np.float32)
    A = rng.standard_normal((P, te, te)).astype(np.float32)
    minv = (A @ A.transpose(0, 2, 1)).reshape(P, te * te)
    gf = max(8, -(-tf // 8) * 8)
    ts, tb, max_rows = pk.plan_row_tiles(pt, P + 1, target_rows=256)
    JT, ids_T = pk.prep_matvec_rows(
        jnp.asarray(Jf.reshape(B, -1)), jnp.asarray(Je.reshape(B, -1)),
        jnp.asarray(pt), jnp.asarray(cam), max_rows, r, tf, te)
    sc_T = np.zeros((gf, 128), np.float32)
    sc_T[:tf, :C] = 1.0
    pw = np.zeros((P + 1 + 128, 128), np.float32)
    pw[:P, 0:te] = se
    pw[:P, 8:8 + te * te] = minv
    corr, ftf, _ = pk.schur_assembly(
        JT, ids_T, jnp.asarray(sc_T), jnp.asarray(pw), jnp.asarray(ts),
        jnp.asarray(tb), P, C, r, tf, te, max_rows=max_rows, interpret=True,
        mode="schur_jacobi")
    ref = np.asarray(ftf - corr)[:C].reshape(C, tf, gf)[:, :, :tf]
    plan, JTt = _port_plan_and_jt(Jf, Je, pt, cam, P, C)
    got = kn.schur_jacobi_blocks_plain(JTt, torch.as_tensor(se.astype(np.float64)),
                                       torch.as_tensor(minv.astype(np.float64)), plan)
    np.testing.assert_allclose(got.reshape(C, tf, tf).numpy(), ref, rtol=5e-4,
                               atol=5e-3)


@pytest.mark.parametrize("case", ["eta", "r_tolerance", "max_iterations",
                                  "min_iterations", "identity", "zero_rhs",
                                  "indefinite"])
def test_cg_matches_jax(case):
    """The port's CG against ceres_tpu's on one SPD system (an
    indefinite one for "indefinite"): the same iteration count and
    termination code, x to 1e-12 relative."""
    rng = np.random.default_rng(11)
    n = 40
    G = rng.standard_normal((n, n))
    A = G @ G.T / n + 0.5 * np.eye(n)  # condition number about 10
    if case == "indefinite":
        A = A - 2.0 * np.eye(n)
    b = rng.standard_normal(n) if case != "zero_rhs" else np.zeros(n)
    d = 1.0 / np.diag(A)
    kw = dict(min_num_iterations=0, max_num_iterations=100,
              residual_reset_period=10, r_tolerance=-1.0, q_tolerance=1e-3)
    if case == "eta":
        kw["q_tolerance"] = 0.1
    elif case == "r_tolerance":
        kw.update(q_tolerance=-1.0, r_tolerance=1e-6)
    elif case == "max_iterations":
        kw.update(q_tolerance=-1.0, max_num_iterations=7)
    elif case == "min_iterations":
        kw.update(q_tolerance=0.5, min_num_iterations=6)
    use_prec = case != "identity"
    ref = jcg.conjugate_gradients(
        lambda x: jnp.asarray(A) @ x, jnp.asarray(b), jnp.zeros(n),
        (lambda v: jnp.asarray(d) * v) if use_prec else None, **kw)
    At, dt_ = torch.as_tensor(A), torch.as_tensor(d)
    syncs = []

    def fetch(*s):
        syncs.append(len(s))
        return torch.stack([v.to(torch.float64).reshape(()) for v in s]).tolist()

    out = tcg.conjugate_gradients(
        lambda x: At @ x, torch.as_tensor(b), torch.zeros(n, dtype=torch.float64),
        (lambda v: dt_ * v) if use_prec else None, fetch=fetch, **kw)
    assert out.num_iterations == int(ref.num_iterations)
    assert out.termination == int(ref.termination)
    assert len(syncs) == max(out.num_iterations, 1)
    x_ref = np.asarray(ref.x)
    scale = max(np.abs(x_ref).max(), 1e-300)
    assert np.abs(out.x.numpy() - x_ref).max() <= 1e-12 * scale


def test_synthetic_bal_large_matches_jax():
    """Same seed, same draws: indices, cameras and points exactly equal,
    observations to 1e-12 relative to the pixel scale (each package's own
    float64 residual)."""
    kw = dict(num_cameras=60, num_points=2000, mean_track=4.4, cam_window=5,
              seed=3)
    ref = jbal.synthetic_bal_large(**kw)
    out = tbal.synthetic_bal_large(**kw)
    np.testing.assert_array_equal(out.camera_index, ref.camera_index)
    np.testing.assert_array_equal(out.point_index, ref.point_index)
    np.testing.assert_array_equal(out.cameras, ref.cameras)
    np.testing.assert_array_equal(out.points, ref.points)
    scale = np.abs(ref.observations).max()
    np.testing.assert_allclose(out.observations, ref.observations, rtol=0,
                               atol=1e-12 * scale)


def test_iterative_program_builds_no_pair_plan():
    """A Venice-shaped program cut to 2,048 cameras: the ITERATIVE_SCHUR
    step builds the row and camera plans only, nothing of size C^2 and no
    row pairs; the dense step asks for the pair plan, built on request."""
    b = tbal.synthetic_bal_large(num_cameras=2048, num_points=30000, seed=0)
    prog = CompiledProgram(tbal.build_problem_batched(b)[0], "float64", device="cpu")
    ops = IterativeSchurStepOps(prog, ctt.Options(linear_solver_type=IS), [1])
    plan = ops.flat.plan
    assert plan.pairs is None
    biggest = max(t.numel() for t in (plan.pt_idx, plan.cam_idx, plan.pt_start,
                                      plan.cam_rows, plan.cam_chunk_start,
                                      plan.cam_level_first))
    assert biggest == plan.B < plan.C * plan.C
    small = port_problem(small_bal())[0]
    dense = DenseSchurStepOps(CompiledProgram(small, "float64", device="cpu"),
                              ctt.Options(fused_loop="ALWAYS",
                                          linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR),
                              [1])
    assert dense.flat.plan.pairs is not None


def _jax_solve(b, prec, **kw):
    jb = jbal.BALProblem(b.cameras.copy(), b.points.copy(), b.camera_index,
                         b.point_index, b.observations)
    return ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
                               preconditioner_type=ct.PreconditionerType[prec],
                               fused_loop="ALWAYS", **kw),
                    jbal.build_problem_batched(jb)[0])


@pytest.fixture(scope="module")
def solved():
    b = small_bal()
    out = {}
    for prec in ("SCHUR_JACOBI", "IDENTITY"):
        ref = _jax_solve(b, prec)
        kn.reset_counts()
        s = ctt.solve(ctt.Options(fused_loop="ALWAYS", linear_solver_type=IS,
                                  preconditioner_type=ctt.PreconditionerType[prec]),
                      port_problem(b)[0], device="cpu")
        counts = {k.__name__: (k.launches, k.plain_calls) for k in kn.KERNELS}
        out[prec] = (ref, s, counts)
    return b, out


def test_iterative_solve_matches_jax_row_for_row(solved):
    """ctt.solve against ct.solve (fused loop), SCHUR_JACOBI, on the
    4-camera, 300-point problem: the same termination, rows and CG count
    of every row; costs and radii to 1e-9 relative."""
    _, res = solved
    ref, out, _ = res["SCHUR_JACOBI"]
    assert out.termination_type.name == ref.termination_type.name
    assert len(out.iterations) == len(ref.iterations)
    assert ([r.linear_solver_iterations for r in out.iterations]
            == [r.linear_solver_iterations for r in ref.iterations]
            == [0, 3, 7, 5, 14, 2, 4])
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9)
        assert c.trust_region_radius == pytest.approx(a.trust_region_radius, rel=1e-9)
        assert c.step_is_successful == a.step_is_successful
    assert out.final_cost == pytest.approx(ref.final_cost, rel=1e-9)
    assert out.linear_solver_type_used.name == ref.linear_solver_type_used.name
    assert out.preconditioner_type_used.name == ref.preconditioner_type_used.name


def test_identity_preconditioner_matches_jax_as_far_as_cg_repeats(solved):
    """IDENTITY: unpreconditioned CG on this Schur complement needs 18-34
    iterations from the third LM iteration on, and its iterate there
    depends on rounding at the 1e-4 level: ceres_tpu's own fused and host
    loops differ by 1e-4 in the cost of row 3 and take different CG counts
    after it. So the rows before that agree to 1e-9 with the same CG
    counts, and both solves converge to the same minimum to 1e-7."""
    _, res = solved
    ref, out, _ = res["IDENTITY"]
    for a, c in list(zip(ref.iterations, out.iterations))[:3]:
        assert c.linear_solver_iterations == a.linear_solver_iterations
        assert c.cost == pytest.approx(a.cost, rel=1e-9)
        assert c.trust_region_radius == pytest.approx(a.trust_region_radius, rel=1e-9)
    assert out.termination_type.name == ref.termination_type.name
    assert out.final_cost == pytest.approx(ref.final_cost, rel=1e-7)
    assert out.preconditioner_type_used.name == ref.preconditioner_type_used.name == "IDENTITY"


@pytest.mark.parametrize("prec", ["SCHUR_JACOBI", "IDENTITY"])
def test_iterative_solve_counts_kernels_and_host_syncs(solved, prec):
    """On the CPU the five kernels of the path run their plain versions
    (isc_matvec at least once per CG iteration, the Schur-Jacobi blocks
    once per LM iteration with that preconditioner), the dense assembly
    never; the host syncs once per LM iteration, once before the first and
    once per CG iteration."""
    _, res = solved
    _, out, counts = res[prec]
    n_it = len(out.iterations) - 1
    cg = sum(r.linear_solver_iterations for r in out.iterations)
    assert out.num_host_syncs == n_it + 1 + cg
    assert all(launches == 0 for launches, _ in counts.values())
    for name in ("eval_fused", "post_eval_fused", "normal_matvec"):
        assert counts[name][1] >= n_it, name
    assert counts["isc_matvec"][1] >= cg + n_it
    assert counts["schur_jacobi_blocks"][1] == (n_it if prec == "SCHUR_JACOBI" else 0)
    assert counts["schur_assembly"][1] == 0


def test_jacobi_runs_as_schur_jacobi(solved):
    """JACOBI takes the SCHUR_JACOBI step (fused_lm.py:237-239): the same
    rows bit for bit."""
    b, res = solved
    s = ctt.solve(ctt.Options(fused_loop="ALWAYS", linear_solver_type=IS,
                              preconditioner_type=ctt.PreconditionerType.JACOBI),
                  port_problem(b)[0], device="cpu")
    ref = res["SCHUR_JACOBI"][1]
    assert [r.cost for r in s.iterations] == [r.cost for r in ref.iterations]
    assert s.preconditioner_type_used == ctt.PreconditionerType.JACOBI


def test_iterative_float32_solve_reaches_the_float64_cost(solved):
    """evaluation_dtype="float32" runs the same path in float32: its final
    cost is within 1e-5 relative of the float64 solve's."""
    b, res = solved
    s32 = ctt.solve(ctt.Options(fused_loop="ALWAYS",
                                linear_solver_type=IS, evaluation_dtype="float32"),
                    port_problem(b)[0], device="cpu")
    assert s32.is_solution_usable()
    assert s32.final_cost == pytest.approx(res["SCHUR_JACOBI"][1].final_cost, rel=1e-5)
