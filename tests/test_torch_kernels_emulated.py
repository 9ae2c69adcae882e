"""The CUDA sources of the port's four kernels, compiled with the host C++
compiler against a CPU stand-in for the CUDA runtime
(tests/cuda_emulation/cuda_runtime.h), run through the wrappers' own
kernel path and held against the plain versions. This checks what the
kernels compute (indexing, the camera and pair plans, the partial sums)
without a card; it does not replace the check on the card, where nvcc
builds them (tests/test_torch_cuda.py, chip_smoke.py)."""
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
    return {
        "eval_fused": (cams, pts, prog.kinds[0].data, plan, q.rows_fn),
        "post_eval_fused": (JT, rT, plan),
        "schur_assembly": (JT, rand(C, 9), rand(P, 3), K, rand(P, 3), plan),
        "normal_matvec": (JT, rand(C, 9), rand(P, 3), plan),
    }


@pytest.mark.parametrize("dtype,num_cameras,num_points", [
    ("float64", 5, 80), ("float32", 5, 80), ("float64", 12, 300)])
@pytest.mark.parametrize("name", ["eval_fused", "post_eval_fused",
                                  "schur_assembly", "normal_matvec"])
def test_emulated_kernel_matches_plain(kernel_path, name, dtype, num_cameras,
                                       num_points):
    """Relative to each output's largest entry: 1e-12 in float64 (sums in
    another order), 1e-5 in float32. The 12-camera problem has 144 camera
    pairs and about 75 rows per camera, so more than one chunk each."""
    args = _inputs(dtype, num_cameras, num_points)[name]
    wrapper, plain = getattr(kn, name), getattr(kn, name + "_plain")
    kn.reset_counts()
    out = kernel_path(wrapper, *args)
    ref = plain(*args)
    assert wrapper.launches == 1 and wrapper.plain_calls == 0
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        err = (o.double() - r.double()).abs().max().item()
        assert err <= LIMIT[r.dtype] * r.double().abs().max().item()
