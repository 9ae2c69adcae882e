"""The flat Schur path of ceres_tpu_torch on the libmv bundle adjuster's
model against ceres_tpu on the same inputs, on the CPU (the kernels' plain
versions): the residual and its Jacobians, the file reader, the Schur
ordering, the flat post-evaluation, a program of two residual kinds, the
flat dense step against the jt step on a BAL problem, and the routing
between the two paths (the one-kind solves are in
test_torch_libmv_solve.py). Problems come from chip_smoke.libmv_instance
on a small BAL geometry; each tolerance is stated where it is used."""
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu.models import libmv as jlibmv
from ceres_tpu.ops import bsr as jbsr
from ceres_tpu.ops import partition as jpt
from ceres_tpu.ops.flatops import FlatSchurOps as JaxFlatSchurOps
from ceres_tpu.program import CompiledProgram as JaxProgram

import ceres_tpu_torch as ctt
import chip_smoke
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.models import libmv as tlibmv
from ceres_tpu_torch.ops import flatops as fo
from ceres_tpu_torch.ops import kernels as kn
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.solvers.fused_lm import (
    DenseSchurStepOps,
    FlatDenseSchurStepOps,
    FlatIterativeSchurStepOps,
    IterativeSchurStepOps,
    build_fused_minimizer,
)
from ceres_tpu_torch.utils import ordering

DS = ctt.LinearSolverType.DENSE_SCHUR
IS = ctt.LinearSolverType.ITERATIVE_SCHUR


def small_libmv():
    """5 cameras, 120 points: the libmv16 recipe on a small geometry."""
    b = tbal.synthetic_bal(num_cameras=5, num_points=120, visibility=1.0, seed=0)
    return chip_smoke.libmv_instance(b, tbal.perturb(b, 0.02, 0.2, 0.2, seed=1))


def jax_lp(lp):
    return jlibmv.LibmvProblem(
        lp.is_image_space, lp.intrinsics.copy(), lp.cameras.copy(), lp.camera_images,
        lp.points.copy(), lp.point_tracks, lp.marker_cam, lp.marker_pt,
        lp.markers.copy())


def rel_err(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


def test_residual_and_jacobians_match_jax():
    """Cameras, points and intrinsics with distortion, and one camera at
    zero rotation (the small-angle branch): 1e-12 relative."""
    rng = np.random.default_rng(0)
    n = 50
    cams = np.concatenate([rng.standard_normal((n, 3)) * 0.2,
                           rng.standard_normal((n, 3)) * 0.1 + [0, 0, 8]], 1)
    cams[0, :3] = 0.0
    pts = rng.standard_normal((n, 3))
    intr = np.stack([np.full(n, 600.0), rng.uniform(-5, 5, n), rng.uniform(-5, 5, n),
                     *(rng.uniform(-0.1, 0.1, (5, n)))], 1)
    obs = rng.standard_normal((n, 2)) * 10
    f = jax.vmap(jax.jacfwd(jlibmv.libmv_reprojection_residual, argnums=(0, 1, 2)))
    ref_j = f(*(jnp.asarray(a) for a in (cams, pts, intr, obs)))
    ref_r = jax.vmap(jlibmv.libmv_reprojection_residual)(
        *(jnp.asarray(a) for a in (cams, pts, intr, obs)))
    res, jacs = tlibmv.LIBMV_COST.batched_residuals_and_jacobians(
        tuple(torch.as_tensor(a) for a in (cams, pts, intr)), torch.as_tensor(obs))
    assert rel_err(res.numpy(), ref_r) <= 1e-12
    for J, R in zip(jacs, ref_j):
        assert J.shape == R.shape
        assert rel_err(J.numpy(), R) <= 1e-12


def _write_libmv_file(path, big_endian):
    rng = np.random.default_rng(3)
    e = ">" if big_endian else "<"
    out = [b"V" if big_endian else b"v", struct.pack(e + "B", ord("P")),
           struct.pack(e + "8f", 700.0, 320.0, 240.0, 0.01, -0.002, 0.0, 1e-4, 2e-4)]
    images, tracks = [3, 7, 9], [11, 12, 13, 14]
    out.append(struct.pack(e + "i", len(images)))
    for im in images:
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        w, x, y, z = q
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
        out.append(struct.pack(e + "i", im))
        out.append(struct.pack(e + "9f", *R.reshape(-1, order="F")))
        out.append(struct.pack(e + "3f", *rng.standard_normal(3)))
    out.append(struct.pack(e + "i", len(tracks)))
    for tr in tracks:
        out.append(struct.pack(e + "i", tr))
        out.append(struct.pack(e + "3f", *rng.standard_normal(3)))
    markers = [(im, tr) for im in images for tr in tracks] + [(5, 11), (3, 99)]
    out.append(struct.pack(e + "i", len(markers)))
    for im, tr in markers:  # the last two name an unknown image and track
        out.append(struct.pack(e + "ii", im, tr))
        out.append(struct.pack(e + "2f", *rng.uniform(0, 640, 2)))
    path.write_bytes(b"".join(out))


@pytest.mark.parametrize("big_endian", [False, True])
def test_read_libmv_file_matches_jax(tmp_path, big_endian):
    """Both readers on one file: the same arrays; the cameras' angle-axis
    (from each package's rotation_matrix_to_angle_axis) to 1e-14."""
    path = tmp_path / "problem.bin"
    _write_libmv_file(path, big_endian)
    ref = jlibmv.read_libmv_file(path)
    out = tlibmv.read_libmv_file(path)
    assert out.is_image_space == ref.is_image_space
    for name in ("intrinsics", "camera_images", "points", "point_tracks", "marker_cam",
                 "marker_pt", "markers"):
        np.testing.assert_array_equal(getattr(out, name), getattr(ref, name), name)
    np.testing.assert_allclose(out.cameras, ref.cameras, rtol=0, atol=1e-14)
    assert out.marker_cam.shape == (12,)


def test_schur_ordering_eliminates_the_points():
    """eligible_e_sets picks the points (P*3 > C*6 + 8) and leaves two f
    families, cameras and the intrinsics; the summary's structure is
    "2,3,d"."""
    from ceres_tpu_torch.solver import _schur_structure_string

    prog = CompiledProgram(tlibmv.build_problem(small_libmv())[0], device="cpu")
    assert [f.asize for f in prog.families] == [6, 3, 8]
    assert ordering.eligible_e_sets(prog) == [1]
    assert _schur_structure_string(prog, [1]) == "2,3,d"


def test_flat_post_eval_matches_jax():
    """g, column norms and the J'J blocks of every family, the port's
    fused_post_eval_e/f against the JAX package's on the same program and
    state: 1e-12 relative to each output's largest entry."""
    lp = small_libmv()
    jprog = JaxProgram(jlibmv.build_problem(jax_lp(lp))[0], sort_rows=True)
    jpm = jpt.build_partition(jbsr.build_meta(jprog), [1])
    jfo = JaxFlatSchurOps(jpm)
    o = jprog._eval_core(jprog.initial_state(), True, False)
    vflat = jfo.flatten(o["block_jacs"])
    prog = CompiledProgram(tlibmv.build_problem(lp)[0], device="cpu")
    ops = FlatIterativeSchurStepOps(prog, ctt.Options(linear_solver_type=IS), [1])
    cost, vrep = ops.evaluate(prog.initial_state())
    assert float(cost) == pytest.approx(float(o["cost"]), rel=1e-13)
    for side in ("e", "f"):
        ref = getattr(jfo, f"fused_post_eval_{side}")(vflat, o["residuals"])
        out = getattr(ops.flat, f"fused_post_eval_{side}")(vrep.vflat, vrep.r)
        assert rel_err(out[0], ref[0]) <= 1e-12
        assert rel_err(out[1], ref[1]) <= 1e-12
        assert len(out[2]) == len(ref[2]) == (1 if side == "e" else 2)
        for a, b in zip(out[2], ref[2]):
            assert rel_err(a, b) <= 1e-12


def _jax_solve(problem, lst, dtype):
    return ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType[lst],
                               preconditioner_type=ct.PreconditionerType.SCHUR_JACOBI,
                               evaluation_dtype=dtype, fused_loop="ALWAYS"), problem)


def _port_solve(problem, lst, dtype):
    kn.reset_counts()
    s = ctt.solve(ctt.Options(fused_loop="ALWAYS", linear_solver_type=ctt.LinearSolverType[lst],
                              preconditioner_type=ctt.PreconditionerType.SCHUR_JACOBI,
                              evaluation_dtype=dtype), problem, device="cpu")
    return s, {k.__name__: (k.launches, k.plain_calls) for k in kn.KERNELS}


def _two_kind_problem(lp, P):
    """The markers split over two batched adds of one cost: even and odd."""
    p = P.Problem()
    cams = p.add_parameter_block_array(lp.cameras.copy())
    pts = p.add_parameter_block_array(lp.points.copy())
    intr = p.add_parameter_block_array(lp.intrinsics.reshape(1, 8).copy())
    cost = (tlibmv.LIBMV_COST if P is ctt else
            ct.AutoDiffCostFunction(jlibmv.libmv_reprojection_residual, 2, [6, 3, 8]))
    for half in (slice(0, None, 2), slice(1, None, 2)):
        n = lp.marker_cam[half].shape[0]
        p.add_residual_block_batch(
            cost, None, [(cams, lp.marker_cam[half]), (pts, lp.marker_pt[half]),
                         (intr, np.zeros(n, np.int64))], data=lp.markers[half])
    return p


@pytest.mark.parametrize("lst", ["DENSE_SCHUR", "ITERATIVE_SCHUR"])
def test_two_kind_program_matches_jax(lst):
    """Two residual kinds, each with its own row order and plans: float64,
    the same rows and CG counts, costs to 1e-9 relative."""
    lp = small_libmv()
    ref = _jax_solve(_two_kind_problem(lp, ct), lst, "float64")
    out, counts = _port_solve(_two_kind_problem(lp, ctt), lst, "float64")
    assert len(out.iterations) == len(ref.iterations)
    assert ([r.linear_solver_iterations for r in out.iterations]
            == [r.linear_solver_iterations for r in ref.iterations])
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9)


def test_flat_dense_step_matches_the_jt_step_on_bal():
    """On one BAL problem the flat DENSE_SCHUR step, built directly,
    against the jt step: gradient, column norms, step and model cost
    change to 1e-10 relative in float64 (the evaluations differ in the
    rotation's branch-free form by ~1e-13)."""
    b = tbal.perturb(tbal.synthetic_bal(num_cameras=4, num_points=60, visibility=0.6,
                                        seed=1), 0.01, 0.05, 0.05, seed=2)
    prog = CompiledProgram(tbal.build_problem_batched(b)[0], device="cpu")
    opts = ctt.Options(linear_solver_type=DS)
    jt, flat = DenseSchurStepOps(prog, opts, [1]), FlatDenseSchurStepOps(prog, opts, [1])
    x = prog.initial_state()
    (cj, vj), (cf, vf) = jt.evaluate(x), flat.evaluate(x)
    assert float(cf) == pytest.approx(float(cj), rel=1e-12)
    gj, sj, auxj = jt.post_eval(vj)
    gf, sf, auxf = flat.post_eval(vf)
    assert rel_err(gf, gj) <= 1e-10 and rel_err(sf, sj) <= 1e-10
    scale = 1.0 / (1.0 + torch.sqrt(sj))
    D2 = torch.clamp(scale * scale * sj, 1e-6, 1e32) / 1e4
    step_j, mcc_j, _ = jt.compute_step(vj, auxj, gj, scale, D2, None)
    step_f, mcc_f, _ = flat.compute_step(vf, auxf, gf, scale, D2, None)
    assert rel_err(step_f, step_j) <= 1e-10
    assert float(mcc_f) == pytest.approx(float(mcc_j), rel=1e-10)


def test_routing_between_the_jt_and_the_flat_path():
    """BAL with SNAVELY_COST takes the jt steps, the libmv model the flat
    ones, for both tiers; jt_refusal says why."""
    b = tbal.synthetic_bal(num_cameras=3, num_points=30, visibility=0.7, seed=2)
    bal_prog = CompiledProgram(tbal.build_problem_batched(b)[0], device="cpu")
    lm_prog = CompiledProgram(tlibmv.build_problem(small_libmv())[0], device="cpu")
    for tier, jt_cls, flat_cls in (("schur_dense", DenseSchurStepOps, FlatDenseSchurStepOps),
                                   ("schur_iterative", IterativeSchurStepOps,
                                    FlatIterativeSchurStepOps)):
        opts = ctt.Options(linear_solver_type=DS if tier == "schur_dense" else IS)
        assert type(build_fused_minimizer(bal_prog, opts, tier, [1]).ops) is jt_cls
        assert type(build_fused_minimizer(lm_prog, opts, tier, [1]).ops) is flat_cls
    from ceres_tpu_torch.ops import bsr, partition

    pm = partition.build_partition(bsr.build_meta(lm_prog), [1])
    assert fo.jt_refusal(pm, lm_prog) == "not one residual kind of two slots"
    with pytest.raises(ValueError, match="jt path does not take"):
        fo.JTSchurOps(pm, lm_prog)


@pytest.mark.parametrize("t", [2, 6, 8])
def test_chol_inv_lower_flat_general_t(t):
    """K = L^{-1} of SPD blocks for t other than 3: K M K' = I to 1e-12."""
    rng = np.random.default_rng(t)
    A = rng.standard_normal((5, t, t))
    M = torch.as_tensor(A @ A.transpose(0, 2, 1) + t * np.eye(t))
    K = fo.chol_inv_lower_flat(M.reshape(5, t * t), t).reshape(5, t, t)
    assert torch.all(torch.triu(K, 1) == 0)
    eye = K @ M @ K.transpose(1, 2)
    assert (eye - torch.eye(t, dtype=M.dtype)).abs().max().item() <= 1e-12
