"""The CUDA sources of the port's kernels, compiled with the host C++
compiler against a CPU stand-in for the CUDA runtime
(tests/cuda_emulation/cuda_runtime.h), run through the wrappers' own
kernel path and held against the plain versions. This checks what the
kernels compute (indexing, the camera, pair and segment plans, the
partial sums) without a card; it does not replace the check on the
card, where nvcc builds them (tests/test_torch_cuda.py, chip_smoke.py)."""
import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.ops import build
from ceres_tpu_torch.ops import kernels as kn
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.solvers.fused_lm import DenseSchurStepOps

ROOT = pathlib.Path(__file__).resolve().parent.parent
LIMIT = {torch.float64: 1e-12, torch.float32: 1e-5}


def _compile(tmp_path_factory, *flags):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    lib_path = tmp_path_factory.mktemp("emu") / "libemu.so"
    cmd = [cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", *flags, "-x", "c++",
           "-I", str(ROOT / "tests" / "cuda_emulation"),
           "-I", str(build.CSRC), *map(str, sorted(build.CSRC.glob("*.cu"))),
           "-o", str(lib_path)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return build.bind(ctypes.CDLL(str(lib_path)))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return _compile(tmp_path_factory)


# a chunk of 4 rows in the small-chunk build: a level tree 3 to 6 levels
# deep at a few thousand rows (kn.CHUNK is set to match while such a
# test builds its plan)
SMALL_CHUNK = 4


@pytest.fixture(scope="module")
def emulated_small_chunk(tmp_path_factory):
    return _compile(tmp_path_factory, f"-DCT_CHUNK={SMALL_CHUNK}")


def _route(lib, monkeypatch):
    """Route the wrappers' CPU tensors to the emulated kernels of lib."""
    monkeypatch.setattr(build, "_LIB", lib)
    monkeypatch.setattr(kn, "_stream", lambda dev: ctypes.c_void_p(0))

    def call(fn, *args):
        monkeypatch.setattr(kn, "_on_cpu", lambda ref: False)
        try:
            return fn(*args)
        finally:
            monkeypatch.setattr(kn, "_on_cpu", lambda ref: True)

    return call


@pytest.fixture
def kernel_path(emulated, monkeypatch):
    return _route(emulated, monkeypatch)


@pytest.fixture
def kernel_path_small_chunk(emulated_small_chunk, monkeypatch):
    monkeypatch.setattr(kn, "CHUNK", SMALL_CHUNK)
    return _route(emulated_small_chunk, monkeypatch)


def _inputs(dtype, num_cameras, num_points):
    b = tbal.perturb(tbal.synthetic_bal(num_cameras=num_cameras,
                                        num_points=num_points,
                                        visibility=3.0 / num_cameras, seed=4),
                     0.01, 0.05, 0.05, seed=1)
    prog = CompiledProgram(tbal.build_problem_batched(b)[0], dtype, device="cpu")
    opts = ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR)
    ops = DenseSchurStepOps(prog, opts, [1])
    plan, q, dt = ops.flat.plan, ops._jt_qual, prog.compute_dtype
    x = prog.initial_state()
    cams = prog.family_table(x, q.fam_f).to(dt).contiguous()
    pts = prog.family_table(x, q.fam_e).to(dt).contiguous()
    _, rT, JT = kn.eval_fused_plain(cams, pts, prog.kinds[0].data, plan, q.rows_fn)
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.as_tensor(rng.uniform(0.5, 1.5, shape)).to(dt)

    P, C = plan.P, plan.C
    K = torch.tril(rand(P, 3, 3)).reshape(P, 9).contiguous()
    A = rand(P, 3, 3)
    minv = (A @ A.transpose(1, 2)).reshape(P, 9).contiguous()  # symmetric
    return {
        "eval_fused": (cams, pts, prog.kinds[0].data, plan, q.rows_fn),
        "post_eval_fused": (JT, rT, plan),
        "schur_assembly": (JT, rand(C, 9), rand(P, 3), K, rand(P, 3), plan),
        "normal_matvec": (JT, rand(C, 9), rand(P, 3), plan),
        "isc_matvec": (JT, rand(C, 9), rand(P, 9), plan, True),
        "isc_matvec_no_u": (JT, rand(C, 9), rand(P, 9), plan, False),
        "schur_jacobi_blocks": (JT, rand(P, 3), minv, plan),
    }


_SIZES = [("float64", 5, 80), ("float32", 5, 80), ("float64", 12, 300)]
# more cameras than a block has threads: the finalize passes span blocks
_MANY_CAMERAS = ("float32", 140, 500)
_DENSE_PATH = ["eval_fused", "post_eval_fused", "schur_assembly", "normal_matvec"]
_ITERATIVE_ONLY = ["isc_matvec", "isc_matvec_no_u", "schur_jacobi_blocks"]


@pytest.mark.parametrize("name,dtype,num_cameras,num_points", [
    (n, *size) for size in _SIZES for n in _DENSE_PATH + _ITERATIVE_ONLY] + [
    (n, *_MANY_CAMERAS) for n in _ITERATIVE_ONLY + ["post_eval_fused",
                                                    "normal_matvec"]])
def test_emulated_kernel_matches_plain(kernel_path, name, dtype, num_cameras,
                                       num_points):
    """Relative to each output's largest entry: 1e-12 in float64 (sums in
    another order), 1e-5 in float32. The 12-camera problem has 144 camera
    pairs and about 75 rows per camera, so more than one chunk each; the
    140-camera one has more cameras than a block has threads."""
    args = _inputs(dtype, num_cameras, num_points)[name]
    name = name.replace("_no_u", "")
    wrapper, plain = getattr(kn, name), getattr(kn, name + "_plain")
    kn.reset_counts()
    out = kernel_path(wrapper, *args)
    ref = plain(*args)
    assert wrapper.launches == 1 and wrapper.plain_calls == 0
    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
    for o, r in zip(out, ref):
        if r is None:
            assert o is None
            continue
        assert o.shape == r.shape
        err = (o.double() - r.double()).abs().max().item()
        assert err <= LIMIT[r.dtype] * r.double().abs().max().item()


_LOSSES = {
    "trivial": lambda: None,
    "huber": lambda: ctt.HuberLoss(1.0),
    "softlone": lambda: ctt.SoftLOneLoss(1.0),
    "cauchy": lambda: ctt.CauchyLoss(0.5),
    "arctan": lambda: ctt.ArctanLoss(2.0),
    "tolerant": lambda: ctt.TolerantLoss(2.0, 0.1),
    "tukey": lambda: ctt.TukeyLoss(2.0),
    "composed": lambda: ctt.ComposedLoss(ctt.HuberLoss(1.1), ctt.SoftLOneLoss(0.5)),
    "scaled": lambda: ctt.ScaledLoss(ctt.CauchyLoss(1.0), 3.0),
}
_EVAL_VARIANTS = ([("angle_axis", n) for n in _LOSSES if n != "trivial"]
                  + [("quat", n) for n in ("trivial", "huber", "cauchy", "tukey",
                                           "composed")])


def _eval_inputs(model, loss_name, dtype):
    """eval_fused's arguments at the start of a 5-camera, 80-point BAL
    problem whose residual norms run from ~0 to ~10 pixels, past every
    loss's kink (and past Tolerant's large-x branch), with the angle-axis
    or the quaternion camera model."""
    b = tbal.perturb(tbal.synthetic_bal(num_cameras=5, num_points=80,
                                        visibility=0.6, seed=4),
                     0.01, 0.05, 0.05, seed=1)
    loss = _LOSSES[loss_name]()
    build = (tbal.build_problem_batched_quat if model == "quat"
             else tbal.build_problem_batched)
    prog = CompiledProgram(build(b, loss)[0], dtype, device="cpu")
    ops = DenseSchurStepOps(
        prog, ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR), [1])
    q, x = ops._jt_qual, prog.initial_state()
    cams = prog.family_table(x, q.fam_f).to(prog.compute_dtype).contiguous()
    pts = prog.family_table(x, q.fam_e).to(prog.compute_dtype).contiguous()
    return cams, pts, prog.kinds[0].data, ops.flat.plan, q.rows_fn, q.loss


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("model,loss_name", _EVAL_VARIANTS)
def test_emulated_eval_fused_variants_match_plain(kernel_path, model, loss_name,
                                                  dtype):
    """The loss chain, the Triggs corrector and the quaternion model's
    tangent lanes of csrc/eval_fused.cu against the plain version (jacfwd,
    J PlusJacobian, loss.py's chain and corrector), each output relative
    to its largest entry: 1e-12 in float64, 1e-5 in float32. Each variant
    counts on its own wrapper."""
    args = _eval_inputs(model, loss_name, dtype)
    s = torch.sum(kn.eval_fused_plain(*args[:5])[1].double() ** 2, dim=0)
    assert float(s.min()) < 0.25 and float(s.max()) > 30.0
    kn.reset_counts()
    out = kernel_path(kn.eval_fused, *args)
    ref = kn.eval_fused_plain(*args)
    variant = ("eval_fused_quat" if model == "quat" else
               "eval_fused_loss" if args[-1].ops else "eval_fused")
    assert {k.__name__: k.launches for k in kn.KERNELS if k.launches} == {variant: 1}
    assert all(k.plain_calls == 0 for k in kn.KERNELS)
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.dtype == r.dtype
        err = (o.double() - r.double()).abs().max().item()
        assert err <= LIMIT[args[0].dtype] * r.double().abs().max().item()


def test_emulated_eval_fused_refuses_what_it_does_not_compute(kernel_path):
    """Another residual, a camera table of the other model's width, or a
    chain longer than the kernel takes: the wrapper raises before
    anything launches."""
    from ceres_tpu_torch import loss as tloss

    cams, pts, obs, plan, rows_fn, loss = _eval_inputs("angle_axis", "huber", "float64")
    kn.reset_counts()
    with pytest.raises(ValueError, match="flat path"):
        kernel_path(kn.eval_fused, cams, pts, obs, plan,
                    lambda c, p, o: tbal.snavely_residual_rows(c, p, o), loss)
    with pytest.raises(ValueError, match="shape"):
        kernel_path(kn.eval_fused, cams, pts, obs, plan, tbal.snavely_quat_residual_rows,
                    loss)
    with pytest.raises(ValueError, match="at most 4 ops"):
        kernel_path(kn.eval_fused, cams, pts, obs, plan, rows_fn,
                    tloss.LossChain(loss.ops * 5))
    assert all(k.launches == 0 for k in kn.KERNELS)


def _flat_inputs(name, dtype):
    """Inputs of the flat path's kernels: widths 3 to 15, blocks without
    rows, the sentinel id (key 100), and one block holding 4,200 rows (two
    levels of chunks). The emulation starts a thread per CUDA thread, so
    the shapes stay small."""
    from ceres_tpu_torch.ops import flatops as fo

    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    rng = np.random.default_rng(len(name))
    n, K = 1200, 101
    if name == "segment_block_sum_one_block":
        n, ids, w = 4200, np.zeros(4200, np.int64), 3
    elif name == "unsorted_segment_sum":
        ids, w = rng.integers(0, K, n), 6
    else:
        ids, w = np.sort(rng.integers(0, K, n)), 15
    x = torch.as_tensor(rng.standard_normal((n, w))).to(dt)
    plan = fo.build_segment_plan(ids, K, "cpu")
    if name.startswith("segment_block_sum") or name == "unsorted_segment_sum":
        return (x, plan)
    if name == "segment_block_expand":
        vals = torch.as_tensor(rng.standard_normal((K, 9))).to(dt)
        return (vals, plan.ids)
    C, te, tf = 16, 3, 6
    cam = rng.integers(0, C + 1, n).astype(np.int32)  # C: a constant camera
    Y = torch.as_tensor(rng.standard_normal((n, te * tf))).to(dt)
    return (Y, torch.as_tensor(cam), plan.seg_start[:K], C, te, tf)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["segment_block_sum", "segment_block_sum_one_block",
                                  "unsorted_segment_sum", "segment_block_expand",
                                  "segment_spread_sum"])
def test_emulated_flat_kernel_matches_plain(kernel_path, name, dtype):
    """The flat path's kernels, relative to the largest entry: 1e-12 in
    float64, 1e-5 in float32 (sums in another order); the gather
    exactly."""
    args = _flat_inputs(name, dtype)
    name = name.replace("_one_block", "")
    wrapper, plain = getattr(kn, name), getattr(kn, name + "_plain")
    kn.reset_counts()
    out = kernel_path(wrapper, *args)
    ref = plain(*args)
    assert wrapper.launches == 1 and wrapper.plain_calls == 0
    assert out.shape == ref.shape and out.dtype == ref.dtype
    err = (out.double() - ref.double()).abs().max().item()
    limit = 0.0 if name == "segment_block_expand" else LIMIT[ref.dtype]
    assert err <= limit * ref.double().abs().max().item()


def _spread_ftf_inputs(dtype, C, B):
    """The Jc form's inputs: 12 points, C cameras and some rows of the
    constant camera C, Y (B, 27), Jc (B, 18), and the camera plan of a row
    plan over the C + 1 camera ids, cut to the C real cameras."""
    import dataclasses

    from ceres_tpu_torch.ops import flatops as fo

    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    rng = np.random.default_rng(C)
    P = 12
    pt = np.sort(rng.integers(0, P, B))
    cam = rng.integers(0, C + 1, B)
    rows = fo.build_row_plan(pt, cam, P, C + 1, "cpu")
    plan = dataclasses.replace(rows, C=C,
                               cam_chunk_first=rows.cam_chunk_first[:C + 1].contiguous())
    Y = torch.as_tensor(rng.standard_normal((B, 27))).to(dt)
    Jc = torch.as_tensor(rng.standard_normal((B, 18))).to(dt)
    return (Y, plan.cam_idx, plan.pt_start, C, 3, 9, Jc, 2, plan)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("C,B", [(4, 150), (3, 400)])
def test_emulated_spread_ftf_matches_plain(kernel_path, dtype, C, B):
    """Kernel 8J (segment_spread_sum with Jc) in one launch and its
    finalize pass, against the plain version: A and F'F relative to their
    largest entry, 1e-12 in float64, 1e-5 in float32. At 400 rows each
    camera owns more than one chunk; the constant camera's rows add
    nothing."""
    args = _spread_ftf_inputs(dtype, C, B)
    kn.reset_counts()
    out = kernel_path(kn.segment_spread_sum, *args)
    ref = kn.segment_spread_ftf_plain(*args)
    assert kn.segment_spread_ftf.launches == 1
    assert kn.segment_spread_ftf.plain_calls == 0
    if B == 400:
        assert args[-1].n_cam_chunks > C + 1
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.dtype == r.dtype
        err = (o.double() - r.double()).abs().max().item()
        assert err <= LIMIT[r.dtype] * r.double().abs().max().item()


def test_emulated_spread_ftf_refuses_what_it_does_not_take(kernel_path):
    """Jc rows wider than the kernel stages, or no camera plan: the wrapper
    raises before anything launches."""
    Y, cam, pt_start, C, te, tf, Jc, r, plan = _spread_ftf_inputs("float64", 4, 150)
    kn.reset_counts()
    with pytest.raises(ValueError, match="at most 32"):
        kernel_path(kn.segment_spread_sum, Y, cam, pt_start, C, te, tf,
                    torch.cat([Jc, Jc], dim=1), 4, plan)
    with pytest.raises(ValueError, match="camera plan"):
        kernel_path(kn.segment_spread_sum, Y, cam, pt_start, C, te, tf, Jc, r, None)
    assert kn.segment_spread_ftf.launches == 0


def _isc_long_inputs(dtype, emit_u):
    """isc_matvec's arguments on a row plan that reaches every branch of
    the redesigned kernel (tests/test_torch_row_plan.py's "long_track"
    structure): one point of 600 rows (past a point block's
    kn.POINT_BLOCK rows: a block of its own that loops), points without
    rows, tracks of 1 to 5 rows, and a camera holding about 4,400 rows (past
    CHUNK chunks of CHUNK rows: a second level of the camera sum)."""
    from ceres_tpu_torch.ops import flatops as fo
    from test_torch_row_plan import _structure

    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    pt, cam, P, C = _structure("long_track")
    plan = fo.build_row_plan(pt, cam, P, C, "cpu")
    assert len(plan.cam_levels) == 2 and int(np.bincount(cam)[0]) > kn.CHUNK ** 2
    rng = np.random.default_rng(11)
    JT = torch.as_tensor(rng.standard_normal((kn.LANES, pt.shape[0]))).to(dt)
    z = torch.as_tensor(rng.standard_normal((C, 9))).to(dt)
    A = rng.standard_normal((P, 3, 3))
    minv = torch.as_tensor((A @ A.transpose(0, 2, 1)).reshape(P, 9)).to(dt)
    return JT, z, minv, plan, emit_u


@pytest.mark.parametrize("emit_u", [True, False], ids=["isc_matvec", "isc_matvec_no_u"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_emulated_isc_matvec_long_track_and_large_camera(kernel_path, dtype, emit_u):
    """csrc/isc_matvec.cu's looping point block and its second camera level
    against the plain version, each output relative to its largest entry:
    1e-12 in float64, 1e-5 in float32 (sums in another order); one launch
    for the whole call."""
    args = _isc_long_inputs(dtype, emit_u)
    kn.reset_counts()
    cam, u = kernel_path(kn.isc_matvec, *args)
    cam_ref, u_ref = kn.isc_matvec_plain(*args)
    assert kn.isc_matvec.launches == 1 and kn.isc_matvec.plain_calls == 0
    assert (u is None) == (not emit_u)
    for o, r in ((cam, cam_ref), (u, u_ref)) if emit_u else ((cam, cam_ref),):
        assert o.shape == r.shape and o.dtype == r.dtype
        err = (o.double() - r.double()).abs().max().item()
        assert err <= LIMIT[r.dtype] * r.double().abs().max().item()


def _expand_inputs(dtype, t, N=2501, K=301):
    """A table (K, t) whose last row is the sentinel zero row, and N ids in
    no order over all K rows (the sentinel's among them); the last block's
    453 rows are no whole number of 16-byte groups at any odd t."""
    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    rng = np.random.default_rng(t)
    vals = torch.as_tensor(rng.standard_normal((K, t))).to(dt)
    vals[-1] = 0
    ids = rng.integers(0, K, N)
    ids[::97] = K - 1
    return vals, torch.as_tensor(ids.astype(np.int32))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("t", [1, 3, 6, 8, 9, 13])
def test_emulated_segment_block_expand_widths(kernel_path, dtype, t):
    """Every width: the templated kernels (3, 6, 8, 9, with their 16-byte
    stores and the ragged tail) and the generic one (1, 13): a copy, so
    exactly the plain version."""
    vals, ids = _expand_inputs(dtype, t)
    kn.reset_counts()
    out = kernel_path(kn.segment_block_expand, vals, ids)
    assert kn.segment_block_expand.launches == 1
    assert kn.segment_block_expand.plain_calls == 0
    assert torch.equal(out, kn.segment_block_expand_plain(vals, ids))



def _point_block_inputs(name, dtype, structure="long_tracks"):
    """normal_matvec's or post_eval_fused's arguments on a row plan of
    tests/test_torch_row_plan.py: "long_tracks" has points of 600, 256,
    257 and 1,000 rows (past a point block's kn.POINT_BLOCK rows, blocks
    that loop; 256 rows fill one exactly), points without rows, points of
    one row and tracks of 2 to 5, a camera of about 5,600 rows (past CHUNK
    chunks of CHUNK rows: a second camera level) and B not a multiple of a
    block; J, r and x random."""
    from ceres_tpu_torch.ops import flatops as fo
    from test_torch_row_plan import _structure

    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    pt, cam, P, C = _structure(structure)
    plan = fo.build_row_plan(pt, cam, P, C, "cpu")
    rng = np.random.default_rng(13)
    B = pt.shape[0]
    JT = torch.as_tensor(rng.standard_normal((kn.LANES, B))).to(dt)
    if name == "post_eval_fused":
        return JT, torch.as_tensor(rng.standard_normal((kn.R, B))).to(dt), plan
    xc = torch.as_tensor(rng.standard_normal((C, kn.TF))).to(dt)
    xp = torch.as_tensor(rng.standard_normal((P, kn.TE))).to(dt)
    return JT, xc, xp, plan


def _run_and_hold(call, name, args, repeat=True):
    """One call of the wrapper through the emulated kernel against the
    plain version, each output relative to its largest entry (1e-12 in
    float64, 1e-5 in float32: sums in another order), one launch for the
    call; with `repeat`, a second call gives the same bits. Returns the
    outputs."""
    wrapper, plain = getattr(kn, name), getattr(kn, name + "_plain")
    kn.reset_counts()
    out = call(wrapper, *args)
    ref = plain(*args)
    assert wrapper.launches == 1 and wrapper.plain_calls == 0
    out, ref = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.dtype == r.dtype
        err = (o.double() - r.double()).abs().max().item()
        assert err <= LIMIT[r.dtype] * r.double().abs().max().item()
    if repeat:
        again = call(wrapper, *args)
        again = again if isinstance(again, tuple) else (again,)
        assert all(torch.equal(a, o) for a, o in zip(again, out))
    return out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["normal_matvec", "post_eval_fused"])
def test_emulated_point_block_kernel_long_tracks_and_large_camera(kernel_path, name,
                                                                  dtype):
    """csrc/normal_matvec.cu and csrc/post_eval_fused.cu through the point
    blocks of csrc/point_blocks.cuh: looping blocks, a block of exactly
    kn.POINT_BLOCK rows, points of one row or none, a ragged last block and
    a camera of more than CHUNK**2 rows (two levels of the camera sum by
    rows for normal_matvec; post_eval_fused sums by runs, a few dozen for
    that camera, one level:
    test_emulated_post_eval_fused_run_levels_of_a_deep_tree takes them
    deeper)."""
    args = _point_block_inputs(name, dtype)
    plan = args[-1]
    counts = np.diff(plan.pt_start.numpy())
    assert plan.B % kn.POINT_BLOCK and counts.max() > kn.POINT_BLOCK
    assert (counts == 1).any() and (counts == 0).any() and (counts == kn.POINT_BLOCK).any()
    assert len(plan.cam_levels) == 2
    _run_and_hold(kernel_path, name, args)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_emulated_post_eval_fused_run_levels_of_a_deep_tree(kernel_path_small_chunk,
                                                            dtype):
    """The camera pass's later levels at width 18, over post_eval_fused's
    runs: the kernels built with a chunk of SMALL_CHUNK items and the plan
    cut to match, so the long_tracks structure's large camera takes 2
    levels of runs (the matvecs' rows reach a second level at the real
    chunk: test_emulated_point_block_kernel_long_tracks_and_large_camera,
    test_emulated_isc_matvec_long_track_and_large_camera)."""
    args = _point_block_inputs("post_eval_fused", dtype)
    assert len(args[-1].run_levels) == 2
    _run_and_hold(kernel_path_small_chunk, "post_eval_fused", args)



def _schur_jacobi_inputs(dtype):
    """schur_jacobi_blocks' arguments on _point_block_inputs' "long_tracks"
    row plan: J random, se in [0.5, 1.5], M symmetric positive definite."""
    from ceres_tpu_torch.ops import flatops as fo
    from test_torch_row_plan import _structure

    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    pt, cam, P, C = _structure("long_tracks")
    plan = fo.build_row_plan(pt, cam, P, C, "cpu")
    rng = np.random.default_rng(19)
    JT = torch.as_tensor(rng.standard_normal((kn.LANES, pt.shape[0]))).to(dt)
    se = torch.as_tensor(rng.uniform(0.5, 1.5, (P, 3))).to(dt)
    A = rng.standard_normal((P, 3, 3))
    minv = torch.as_tensor((A @ A.transpose(0, 2, 1) + np.eye(3)).reshape(P, 9)).to(dt)
    return JT, se, minv, plan


def _schur_assembly_inputs(dtype, C, counts, seed=2):
    """schur_assembly's arguments on C cameras and points of counts[p]
    rows, each row's camera drawn at random (so a point's rows may share a
    camera); J random, the scales in [0.5, 1.5], K lower triangular, u
    random."""
    from ceres_tpu_torch.ops import flatops as fo

    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    rng = np.random.default_rng(seed)
    P = counts.shape[0]
    pt = np.repeat(np.arange(P), counts)
    B = pt.shape[0]
    plan = fo.build_row_plan(pt, rng.integers(0, C, B), P, C, "cpu")

    def rand(*shape):
        return torch.as_tensor(rng.uniform(0.5, 1.5, shape)).to(dt)

    JT = torch.as_tensor(rng.standard_normal((kn.LANES, B))).to(dt)
    K = torch.tril(rand(P, 3, 3)).reshape(P, 9).contiguous()
    return JT, rand(C, 9), rand(P, 3), K, rand(P, 3), plan


def _hold_schur(call, name, args, repeat=True):
    """_run_and_hold, and the outputs exactly symmetric: AtA and each 9 x 9
    block of FtF (row 3), each 9 x 9 block of block-diag(S) (rows 3b, 5).
    Returns the outputs."""
    out = _run_and_hold(call, name, args, repeat)
    blocks = (out[1] if name == "schur_assembly" else out[0]).reshape(-1, 9, 9)
    assert torch.equal(blocks, blocks.transpose(1, 2))
    if name == "schur_assembly":
        assert torch.equal(out[0], out[0].T)
    return out


def _pairs_within_one_camera(plan):
    pairs = plan.ensure_pairs()
    a, b = pairs.pair_a.long(), pairs.pair_b.long()
    cam = plan.cam_idx.long()
    return int(((a != b) & (cam[a] == cam[b])).sum())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_emulated_schur_jacobi_long_tracks_and_large_camera(kernel_path, dtype):
    """csrc/schur_jacobi.cu (rows 3b and 5) through the point blocks and
    runs of csrc/point_blocks.cuh: blocks that loop (points of 600, 256, 257
    and 1,000 rows), a ragged last block, points of one row or none; held
    to the plain version (1e-12 of the largest entry in float64, 1e-5 in
    float32), each block exactly symmetric, a second call the same bits."""
    args = _schur_jacobi_inputs(dtype)
    plan = args[-1]
    counts = np.diff(plan.pt_start.numpy())
    assert plan.B % kn.POINT_BLOCK and counts.max() > kn.POINT_BLOCK
    assert (counts == 0).any() and (counts == 1).any()
    _hold_schur(kernel_path, "schur_jacobi_blocks", args)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_emulated_schur_jacobi_run_levels_of_a_deep_tree(kernel_path_small_chunk, dtype):
    """Rows 3b and 5's camera levels past the first, at width 45, and the
    mirrored last store: the kernels built with a chunk of SMALL_CHUNK items
    and the plan cut to match, so the long_tracks structure's large camera
    takes two levels of runs."""
    args = _schur_jacobi_inputs(dtype)
    assert len(args[-1].run_levels) == 2
    _hold_schur(kernel_path_small_chunk, "schur_jacobi_blocks", args)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_emulated_schur_assembly_many_cameras(kernel_path, dtype):
    """csrc/schur_assembly.cu (row 3) at 40 cameras: 820 camera-pair keys,
    more than a block has threads, an AtA of 360 x 360 whose blocks without
    pairs come out zero; points of 1 to 6 rows, some seen twice by one
    camera, one point without rows, a ragged last block. Held to the plain
    version (1e-12 of each output's largest entry in float64, 1e-5 in
    float32), AtA and each FtF block exactly symmetric. One call: the
    emulation runs a block at a time, and each takes ~10 ms."""
    counts = np.random.default_rng(40).integers(1, 7, 100)
    counts[3] = 0
    args = _schur_assembly_inputs(dtype, 40, counts)
    plan = args[-1]
    assert plan.ensure_pairs().n_keys == 820 > kn.POINT_BLOCK
    assert plan.B % kn.POINT_BLOCK and _pairs_within_one_camera(plan) > 0
    out = _hold_schur(kernel_path, "schur_assembly", args, repeat=False)
    assert (out[0] == 0).any()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_emulated_schur_assembly_long_track(kernel_path, dtype):
    """Row 3 with a point of 260 rows over 4 cameras (a block that loops,
    ~65 of its rows in each camera: 33,930 pairs, most within one camera or
    across two, in chunks of up to 64), 300 points of 1 to 4 rows and a
    ragged last block: held to the plain version, exactly symmetric, a
    second call the same bits."""
    counts = np.random.default_rng(4).integers(1, 5, 300)
    counts[150] = 260
    args = _schur_assembly_inputs(dtype, 4, counts)
    plan = args[-1]
    assert plan.B % kn.POINT_BLOCK and counts.max() > kn.POINT_BLOCK
    assert _pairs_within_one_camera(plan) > 4 * 64
    _hold_schur(kernel_path, "schur_assembly", args)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_emulated_schur_assembly_levels_of_a_deep_tree(kernel_path_small_chunk, dtype):
    """Row 3's run levels (width 54, the FtF and U store) and pair levels
    (width 81, the AtA store) past the first: the kernels built with a chunk
    of SMALL_CHUNK items and the plan cut to match, on 2 cameras and 4,200
    points of one row or, every twentieth, four (19 tiles of runs: two run
    levels; 1,260 pairs in 3 keys: four pair levels)."""
    counts = np.ones(4200, np.int64)
    counts[::20] = 4
    args = _schur_assembly_inputs(dtype, 2, counts)
    plan = args[-1]
    assert len(plan.run_levels) == 2 and len(plan.ensure_pairs().pair_levels) == 4
    _hold_schur(kernel_path_small_chunk, "schur_assembly", args, repeat=False)
