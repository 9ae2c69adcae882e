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


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    lib_path = tmp_path_factory.mktemp("emu") / "libemu.so"
    cmd = [cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-x", "c++",
           "-I", str(ROOT / "tests" / "cuda_emulation"),
           "-I", str(build.CSRC), *map(str, sorted(build.CSRC.glob("*.cu"))),
           "-o", str(lib_path)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return build.bind(ctypes.CDLL(str(lib_path)))


@pytest.fixture
def kernel_path(emulated, monkeypatch):
    """Route the wrappers' CPU tensors to the emulated kernels."""
    monkeypatch.setattr(build, "_LIB", emulated)
    monkeypatch.setattr(kn, "_stream", lambda dev: ctypes.c_void_p(0))

    def call(fn, *args):
        monkeypatch.setattr(kn, "_on_cpu", lambda ref: False)
        try:
            return fn(*args)
        finally:
            monkeypatch.setattr(kn, "_on_cpu", lambda ref: True)

    return call


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
