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


# the staged segment_block_sum blocks a card holds at once, as the emulated
# wrappers see it: more than any test's grid, so kn.staged chooses by its
# items rule alone
RESIDENT = 1 << 20


def _route(lib, monkeypatch):
    """Route the wrappers' CPU tensors to the emulated kernels of lib."""
    monkeypatch.setattr(build, "_LIB", lib)
    monkeypatch.setattr(kn, "_stream", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(kn, "_resident_blocks", lambda dev, dt, w: RESIDENT)

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


def _fixed_order_sum(partial, nt):
    """The cost as the last block of csrc/eval_fused.cu sums the partials:
    thread t of nt adds the partials t, t + nt, ... in order from 0, then
    the threads' sums go through the block's tree (ct::block_sum)."""
    acc = [0.0] * nt
    for i, v in enumerate(partial.tolist()):
        acc[i % nt] += v
    s = nt // 2
    while s:
        for t in range(s):
            acc[t] += acc[t + s]
        s //= 2
    return acc[0]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("model,loss_name,num_points", [
    ("angle_axis", "trivial", 80), ("angle_axis", "huber", 80), ("quat", "trivial", 80),
    ("quat", "huber", 80), ("angle_axis", "trivial", 12000)])
def test_emulated_eval_fused_cost_is_the_fixed_order_sum_of_its_partials(
        kernel_path, monkeypatch, model, loss_name, num_points, dtype):
    """eval_fused's cost comes from the launch that forms the rows: its
    block partials (one per kn.EVAL_THREADS rows) summed by the last block
    to finish, equal bit for bit to _fixed_order_sum of them (the order of
    the first design's second launch), for both camera models with and
    without a loss; 12,000 points give more partials than that sum has
    threads (in float64). The count of finished blocks is 0 again after
    each call, so a repeat gives the same bits. The cost is within 1e-12 in
    float64, 1e-5 in float32, of the plain version's."""
    b = tbal.perturb(tbal.synthetic_bal(num_cameras=5, num_points=num_points,
                                        visibility=0.6, seed=4), 0.01, 0.05, 0.05, seed=1)
    build = (tbal.build_problem_batched_quat if model == "quat"
             else tbal.build_problem_batched)
    prog = CompiledProgram(build(b, _LOSSES[loss_name]())[0], dtype, device="cpu")
    ops = DenseSchurStepOps(
        prog, ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR), [1])
    q, x = ops._jt_qual, prog.initial_state()
    args = (prog.family_table(x, q.fam_f).to(prog.compute_dtype).contiguous(),
            prog.family_table(x, q.fam_e).to(prog.compute_dtype).contiguous(),
            prog.kinds[0].data, ops.flat.plan, q.rows_fn, q.loss)
    seen = []
    workspace = kn._eval_workspace

    def spy(n_blocks, dev):
        seen.append(workspace(n_blocks, dev))
        return seen[-1]

    monkeypatch.setattr(kn, "_eval_workspace", spy)
    nt = kn.EVAL_THREADS[args[0].dtype]
    B = ops.flat.plan.B
    outs = []
    for _ in range(2):
        outs.append(kernel_path(kn.eval_fused, *args))
        partial, done = seen[-1]
        assert partial.shape == (-(-B // nt),) and int(done) == 0
        assert float(outs[-1][0]) == _fixed_order_sum(partial, kn.EVAL_SUM_THREADS)
    if num_points > 80 and dtype == "float64":
        assert partial.shape[0] > kn.EVAL_SUM_THREADS
    assert all(torch.equal(o, r) for o, r in zip(outs[1], outs[0]))
    ref = kn.eval_fused_plain(*args)  # rows' costs in the dtype, their sum in float64
    assert abs(float(outs[0][0]) - float(ref[0])) <= LIMIT[args[0].dtype] * float(ref[0])


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
    if name == "segment_block_sum":  # ~11 runs a tile: in place, in float32 too
        assert not kn.staged(args[1], 15, 4, RESIDENT)
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


def _parent_spread(Y, cam, pt_start, C, te, tf):
    """A as the first design of csrc/segment_spread.cu formed it: each entry
    0 and then each row of its point and camera added in row order, in the
    dtype of Y."""
    Y, cam, pt_start = Y.numpy(), cam.numpy(), pt_start.numpy()
    P = pt_start.shape[0] - 1
    A = np.zeros((P, te, C, tf), Y.dtype)
    for p in range(P):
        for b in range(pt_start[p], pt_start[p + 1]):
            if 0 <= cam[b] < C:
                A[p, :, cam[b], :] += Y[b].reshape(te, tf)
    return torch.as_tensor(A.reshape(P, te * C * tf))


def _spread_ftf_inputs(dtype, C, B, counts=None, seed=None):
    """The Jc form's inputs: 12 points (or points of counts[p] rows), C
    cameras and some rows of the constant camera C, Y (B, 27), Jc (B, 18),
    and a row plan over the C + 1 camera ids, cut to the C real cameras
    (the last camera level's chunks of camera C are left out, so its runs
    add nothing)."""
    import dataclasses

    from ceres_tpu_torch.ops import flatops as fo

    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    rng = np.random.default_rng(C if seed is None else seed)
    if counts is None:
        P = 12
        pt = np.sort(rng.integers(0, P, B))
    else:
        P = counts.shape[0]
        pt = np.repeat(np.arange(P), counts)
        B = pt.shape[0]
    cam = rng.integers(0, C + 1, B)
    rows = fo.build_row_plan(pt, cam, P, C + 1, "cpu")
    plan = dataclasses.replace(rows, C=C,
                               run_level_first=rows.run_level_first[:C + 1].contiguous())
    Y = torch.as_tensor(rng.standard_normal((B, 27))).to(dt)
    Jc = torch.as_tensor(rng.standard_normal((B, 18))).to(dt)
    return (Y, plan.cam_idx, plan.pt_start, C, 3, 9, Jc, 2, plan)


def _hold_spread_ftf(call, args):
    """Kernel 8J in its three passes, counted as one launch: A equal bit for
    bit to the first design's sums (_parent_spread), F'F within 1e-12 in
    float64 and 1e-5 in float32 of the plain version relative to its
    largest entry, exactly symmetric, and a repeat gives the same bits."""
    kn.reset_counts()
    A, ftf = call(kn.segment_spread_sum, *args)
    assert kn.segment_spread_ftf.launches == 1
    assert kn.segment_spread_ftf.plain_calls == 0
    assert torch.equal(A, _parent_spread(*args[:6]))
    ref = kn.segment_spread_ftf_plain(*args)[1]
    assert ftf.shape == ref.shape and ftf.dtype == ref.dtype
    err = (ftf.double() - ref.double()).abs().max().item()
    assert err <= LIMIT[ref.dtype] * ref.double().abs().max().item()
    blocks = ftf.reshape(-1, 9, 9)
    assert torch.equal(blocks, blocks.transpose(1, 2))
    again = call(kn.segment_spread_sum, *args)
    assert torch.equal(again[0], A) and torch.equal(again[1], ftf)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("C,B", [(4, 150), (3, 400)])
def test_emulated_spread_ftf_matches_plain(kernel_path, dtype, C, B):
    """Kernel 8J (segment_spread_sum with Jc): its slab pass and F'F's
    point and camera-level passes, held as _hold_spread_ftf says. At 400
    rows the rows take two tiles, so each camera has more than one run;
    the constant camera's rows add nothing."""
    args = _spread_ftf_inputs(dtype, C, B)
    if B == 400:
        assert args[-1].n_tiles == 2 and args[-1].n_runs > C + 1
    _hold_spread_ftf(kernel_path, args)


def _long_spread_counts():
    """Points of 0 to 5 rows, one of 1,100 (more than a point block holds:
    the F'F point pass loops over its tiles) and one of 300."""
    counts = np.random.default_rng(8).integers(0, 6, 400)
    counts[7], counts[250] = 1100, 300
    return counts


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_emulated_spread_ftf_long_point(kernel_path, dtype):
    """8J on points longer than a point block: the F'F point pass loops
    over the long point's tiles, the slab pass's threads walk its 1,100
    rows."""
    args = _spread_ftf_inputs(dtype, 5, 0, counts=_long_spread_counts())
    assert int(np.diff(args[2].numpy()).max()) > 4 * kn.POINT_BLOCK
    _hold_spread_ftf(kernel_path, args)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_emulated_spread_ftf_run_levels_of_a_deep_tree(kernel_path_small_chunk, dtype):
    """8J's camera levels at width 45 over its runs, the kernels built with
    a chunk of SMALL_CHUNK items and the plan cut to match: 3 cameras of
    about 2,000 rows take two levels of runs and more."""
    args = _spread_ftf_inputs(dtype, 3, 0, counts=_long_spread_counts() + 4, seed=1)
    assert len(args[-1].run_levels) >= 2
    _hold_spread_ftf(kernel_path_small_chunk, args)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("te,C,tf,P", [(3, 5, 3, 400), (1, 3, 5, 400), (2, 7, 6, 400),
                                       (3, 16, 9, 400), (3, 400, 9, 12)])
def test_emulated_spread_slab_is_the_first_designs_sums(kernel_path, te, C, tf, P, dtype):
    """The slab pass of segment_spread_sum (row 8) against the first
    design's sums bit for bit, at widths te*C*tf of 45, 15, 84, 432 and
    10,800 values: 45 and 15 not a whole number of 16-byte groups in either
    dtype (16-byte groups cross the slabs' edges, single values at a
    stretch's edges), 10,800 wider than a block's stretch of shared memory
    (each point's slab in pieces); camera ids outside [0, C) on both sides,
    points without rows and one of 1,100 rows, and rows past pt_start[P]
    (no point's)."""
    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    rng = np.random.default_rng(te * C * tf)
    counts = _long_spread_counts()[:P]
    pt_start = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    B = int(pt_start[-1]) + 5
    cam = torch.as_tensor(rng.integers(-1, C + 2, B).astype(np.int32))
    Y = torch.as_tensor(rng.standard_normal((B, te * tf))).to(dt)
    kn.reset_counts()
    A = kernel_path(kn.segment_spread_sum, Y, cam, pt_start, C, te, tf)
    assert kn.segment_spread_sum.launches == 1
    assert torch.equal(A, _parent_spread(Y, cam, pt_start, C, te, tf))


def test_emulated_spread_ftf_refuses_what_it_does_not_take(kernel_path):
    """Jc rows of another camera model than r = 2 rows of tf = 9, or no row
    plan: the wrapper raises before anything launches."""
    Y, cam, pt_start, C, te, tf, Jc, r, plan = _spread_ftf_inputs("float64", 4, 150)
    kn.reset_counts()
    with pytest.raises(ValueError, match="r = 2 Jc rows of tf = 9"):
        kernel_path(kn.segment_spread_sum, Y, cam, pt_start, C, te, tf,
                    torch.cat([Jc, Jc], dim=1), 4, plan)
    with pytest.raises(ValueError, match="camera runs"):
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


# csrc/segment_sum.cu's templated widths, and two it does not template
# (runtime-w instances: 5, and 36, the flat SCHUR_JACOBI camera blocks)
_SEGMENT_WIDTHS = [3, 6, 8, 15, 48, 80, 5, 36]


def _segment_inputs(dtype, w, how, n=1500, K=61):
    """contrib (n, w) and a SegmentPlan over K keys: n no multiple of
    kn.SEG_TILE; "sorted": keys of no row to a few dozen (single-run keys),
    keys of 600 and 500 rows (runs in several tiles) and keys of no row;
    "short": 1,450 rows, keys of no row to a few dozen only, the last one of
    50 rows from the last whole tile over the ragged one, which so holds no
    run (a call of the tile pass alone); "unsorted": ids with camera locality (a
    key's rows spread over a window of rows, so over tiles), some keys of no
    row and a few of one."""
    from ceres_tpu_torch.ops import flatops as fo

    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    rng = np.random.default_rng(w)
    if how == "sorted":
        counts = rng.integers(0, 8, K)
        counts[[7, 40]] = 600, 500
        counts[[3, 50, 51]] = 0
        counts[-1] += n - counts.sum()
        ids = np.repeat(np.arange(K), counts)
    elif how == "short":
        n = 1450  # a ragged tile of 42 rows
        counts = rng.integers(14, 36, K)
        counts[[3, 50, 51]] = 0
        counts[-1] = 50
        live = np.flatnonzero(counts[:-1])
        more = n - counts.sum()
        np.add.at(counts, live[np.arange(abs(more)) % live.size], np.sign(more))
        ids = np.repeat(np.arange(K), counts)
    else:
        ids = np.clip((np.arange(n) / n * (K - 10)).astype(np.int64)
                      + rng.integers(-6, 7, n), 0, K - 11)
        ids[[5, 900, n - 1]] = K - 3, K - 2, K - 1  # keys of one row
    x = torch.as_tensor(rng.standard_normal((n, w))).to(dt)
    return x, fo.build_segment_plan(ids, K, "cpu")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("w", _SEGMENT_WIDTHS)
@pytest.mark.parametrize("how", ["sorted", "short", "unsorted"])
def test_emulated_segment_sums_every_width(kernel_path, how, w, dtype):
    """Rows 6 and 9 (csrc/segment_sum.cu) at every templated width and two
    runtime ones: row 6's tile pass staged (rows of up to 8 values) or
    straight from the rows (wider), single-run keys written straight to
    out, keys whose runs cross tiles summed through their partials, or none
    ("short": every key one run, a last tile of no run); row 9's gather by
    16-byte, 8-byte or 4-byte units, in row phases or along a row; keys of
    no row zero, a ragged last tile; held to the plain version (1e-12
    relative in float64, 1e-5 in float32), one launch, a second call the
    same bits."""
    x, plan = _segment_inputs(dtype, w, how)
    rows = np.bincount(plan.ids.numpy(), minlength=plan.num_keys)
    assert plan.B % kn.SEG_TILE and (rows == 0).any()
    if how != "unsorted":
        assert np.array_equal(plan.empty_keys.numpy(), np.flatnonzero(rows == 0))
        assert (plan.n_partials > 0) == (how == "sorted") and (plan.n_fin > 0) == (
            how == "sorted")
        assert kn.staged(plan, w, x.element_size(), RESIDENT) == (
            w * x.element_size() <= 64)
    if how == "short":
        assert plan.tile_run[-1] == plan.tile_run[-2]  # the ragged tile's rows: no run
    name = "segment_block_sum" if how != "unsorted" else "unsorted_segment_sum"
    out = _run_and_hold(kernel_path, name, (x, plan))[0]
    assert (out[rows == 0] == 0).all()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("w", [8, 80, 5])
def test_emulated_segment_sum_one_key_deep_tree(kernel_path_small_chunk, dtype, w):
    """One key holding every row (libmv's intrinsics block): a run a tile,
    each summed in interleaved parts (w = 8 and 5 staged kn.STAGED_TILES
    tiles a block, w = 80 in place), and the partials of 40 tiles through
    two levels of chunks of SMALL_CHUNK (the kernels built with that chunk
    and the plan cut to match; level_sums at the templated widths 8 and 80,
    a thread per (chunk, column) at 5); a second key of no row is zero."""
    from ceres_tpu_torch.ops import flatops as fo

    n = 40 * kn.SEG_TILE - 37
    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    x = torch.as_tensor(np.random.default_rng(w).standard_normal((n, w))).to(dt)
    plan = fo.build_segment_plan(np.zeros(n, np.int64), 2, "cpu")
    assert plan.n_partials == plan.n_runs == 40 and len(plan.run_levels) == 2
    assert kn.staged(plan, w, x.element_size(), RESIDENT) == (w != 80)
    out = _run_and_hold(kernel_path_small_chunk, "segment_block_sum", (x, plan))[0]
    assert (out[1] == 0).all()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("w", [6, 48])
def test_emulated_unsorted_segment_sum_deep_trees(kernel_path_small_chunk, dtype, w):
    """Row 9's gather with one key of 1,200 of 1,500 rows in no order, past
    CHUNK chunks of CHUNK (the kernels built with a chunk of SMALL_CHUNK and
    the plans cut to match): five levels of chunks, by 16-byte units in row
    phases (w = 6 in float64), single values (6 in float32) or along the row
    (48)."""
    from ceres_tpu_torch.ops import flatops as fo

    rng = np.random.default_rng(w)
    ids = rng.integers(1, 30, 1500)
    ids[rng.permutation(1500)[:1200]] = 0
    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    x = torch.as_tensor(rng.standard_normal((1500, w))).to(dt)
    plan = fo.build_segment_plan(ids, 31, "cpu")
    assert len(plan.level_starts) == 5
    _run_and_hold(kernel_path_small_chunk, "unsorted_segment_sum", (x, plan))
