"""Rules the port keeps: it imports nothing of jax or ceres_tpu, its entry
point runs on the card unless asked for the CPU, and a kernel wrapper
given CUDA tensors launches its kernel or raises, never running the plain
version in its place."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.ops import kernels as kn

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_import_loads_no_jax_and_no_ceres_tpu():
    code = (
        "import sys, ceres_tpu_torch, ceres_tpu_torch.solver, "
        "ceres_tpu_torch.models.bal, ceres_tpu_torch.models.libmv, "
        "ceres_tpu_torch.models.mgh, ceres_tpu_torch.models.test_problems, "
        "ceres_tpu_torch.ops.build, ceres_tpu_torch.parallel.sharded_ba, "
        "ceres_tpu_torch.loss, ceres_tpu_torch.manifolds, ceres_tpu_torch.rotation, "
        "ceres_tpu_torch.models.pose_graph, ceres_tpu_torch.native, "
        "ceres_tpu_torch.ops.inner_product, ceres_tpu_torch.solvers.linear.sparse_schur, "
        "ceres_tpu_torch.solvers.linear.preconditioners, ceres_tpu_torch.utils.clustering, "
        "ceres_tpu_torch.gradient_checker\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'ceres_tpu' or m.startswith('ceres_tpu.')]\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax_and_no_ceres_tpu():
    files = sorted((ROOT / "ceres_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert ROOT / "ceres_tpu_torch" / "parallel" / "sharded_ba.py" in files
    assert ROOT / "ceres_tpu_torch" / "manifolds.py" in files
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "ceres_tpu"}, path


def _docstring_ids(tree):
    out = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
                and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)):
            out.add(id(body[0].value))
    return out


def test_sources_name_no_path_inside_the_jax_package():
    """No string of the port's code (docstrings, which cite their JAX
    counterparts, aside) names the JAX package's directory or a path in it,
    so nothing reads a file there; no C++ or CUDA source of the port
    includes one. The native sources build from the port's own copy."""
    files = sorted((ROOT / "ceres_tpu_torch").rglob("*.py"))
    assert ROOT / "ceres_tpu_torch" / "native" / "__init__.py" in files
    for path in files:
        tree = ast.parse(path.read_text())
        docs = _docstring_ids(tree)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                v = node.value.replace("\\", "/")
                assert v != "ceres_tpu" and "ceres_tpu/" not in v, (path, v)
    sources = [p for ext in ("*.cu", "*.cuh", "*.cc", "*.h")
               for p in (ROOT / "ceres_tpu_torch").rglob(ext)]
    assert ROOT / "ceres_tpu_torch" / "native" / "sparse_cholesky.cc" in sources
    for path in sources:
        for line in path.read_text().splitlines():
            if line.lstrip().startswith("#include"):
                assert "ceres_tpu/" not in line, (path, line)


def test_solve_without_cpu_request_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = tbal.synthetic_bal(num_cameras=3, num_points=20, visibility=0.6, seed=2)
    problem = tbal.build_problem_batched(b)[0]
    opts = ctt.Options(fused_loop="ALWAYS", linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.solve(opts, problem)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.solve(opts, problem, device="cuda")


@pytest.mark.parametrize("kw", [dict(fused_loop="NEVER"), dict()])
def test_host_loop_solve_without_cpu_request_raises_when_no_card(monkeypatch, kw):
    """The host loop's entry point, under fused_loop="NEVER" and under AUTO
    (which takes it for a problem this small): no card and no
    device="cpu" raises; it does not run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = tbal.synthetic_bal(num_cameras=3, num_points=20, visibility=0.6, seed=2)
    problem = tbal.build_problem_batched(b)[0]
    opts = ctt.Options(linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.solve(opts, problem)


def test_libmv_solve_without_cpu_request_raises_when_no_card(monkeypatch):
    """The flat path's entry point too: no card and no device="cpu"."""
    import chip_smoke
    from ceres_tpu_torch.models import libmv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = tbal.synthetic_bal(num_cameras=3, num_points=20, visibility=0.6, seed=2)
    problem = libmv.build_problem(chip_smoke.libmv_instance(b, b))[0]
    opts = ctt.Options(fused_loop="ALWAYS", linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctt.solve(opts, problem)


def test_compiled_program_without_cpu_request_raises_when_no_card(monkeypatch):
    from ceres_tpu_torch.program import CompiledProgram

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = tbal.synthetic_bal(num_cameras=3, num_points=20, visibility=0.6, seed=2)
    problem = tbal.build_problem_batched(b)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompiledProgram(problem)
    assert CompiledProgram(problem, device="cpu").device == torch.device("cpu")


def test_problem_evaluation_without_cpu_request_raises_when_no_card(monkeypatch):
    """Problem.evaluate and Problem.evaluate_residual_block run on the card
    unless asked for the CPU."""
    from ceres_tpu_torch.cost_function import AutoDiffCostFunction

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    problem = ctt.Problem()
    rb = problem.add_residual_block(AutoDiffCostFunction(lambda x: x - 1.0, 2, [2]),
                                    None, [np.asarray([3.0, 0.0])])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        problem.evaluate()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        problem.evaluate_residual_block(rb)
    assert problem.evaluate_residual_block(rb, device="cpu")[0] == 2.5


def test_kernel_wrapper_given_cuda_tensors_does_not_run_the_plain_version(
        monkeypatch):
    """Fake CUDA tensors stand in for a card: the wrapper goes to its kernel
    (which cannot launch here) and raises; no plain version runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ceres_tpu_torch.ops import build

    def no_toolkit():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "find_nvcc", no_toolkit)
    kn.reset_counts()
    with FakeTensorMode(allow_non_fake_inputs=True):
        B, P, C = 6, 3, 2
        i32 = dict(dtype=torch.int32, device="cuda")
        plan = type("Plan", (), dict(
            B=B, P=P, C=C, cam_idx=torch.zeros(B, **i32),
            pt_idx=torch.zeros(B, **i32), pt_start=torch.zeros(P + 1, **i32)))
        f64 = dict(dtype=torch.float64, device="cuda")
        JT = torch.zeros(kn.LANES, B, **f64)
        rT = torch.zeros(kn.R, B, **f64)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kn.post_eval_fused(JT, rT, plan)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kn.normal_matvec(JT, torch.zeros(C, 9, **f64), torch.zeros(P, 3, **f64), plan)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kn.eval_fused(torch.zeros(C, 9, **f64), torch.zeros(P, 3, **f64),
                          torch.zeros(B, 2, **f64), plan, tbal.snavely_residual_rows)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kn.isc_matvec(JT, torch.zeros(C, 9, **f64), torch.zeros(P, 9, **f64),
                          plan, True)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kn.schur_jacobi_blocks(JT, torch.zeros(P, 3, **f64),
                                   torch.zeros(P, 9, **f64), plan)
        seg = type("SegmentPlan", (), dict(
            B=B, num_keys=P + 1, ids=torch.zeros(B, **i32),
            level_starts=(torch.zeros(2, **i32),), level_sizes=(1,),
            key_first=torch.zeros(P + 2, **i32), seg_start=torch.zeros(P + 2, **i32)))
        for wrapper, order in ((kn.segment_block_sum, None),
                               (kn.unsorted_segment_sum, torch.zeros(B, **i32))):
            seg.order = order
            with pytest.raises(RuntimeError, match="nvcc not found"):
                wrapper(torch.zeros(B, 15, **f64), seg)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kn.segment_block_expand(torch.zeros(P + 1, 6, **f64), torch.zeros(B, **i32))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kn.segment_spread_sum(torch.zeros(B, 18, **f64), torch.zeros(B, **i32),
                                  torch.zeros(P + 1, **i32), C, 3, 6)
    assert all(k.plain_calls == 0 and k.launches == 0 for k in kn.KERNELS)


def test_spread_ftf_given_cuda_tensors_does_not_run_the_plain_version(monkeypatch):
    """The Jc form of segment_spread_sum (kernel 8J), as above: on (fake)
    CUDA tensors it goes to its kernel and raises without a toolkit."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ceres_tpu_torch.ops import build

    def no_toolkit():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "find_nvcc", no_toolkit)
    kn.reset_counts()
    with FakeTensorMode(allow_non_fake_inputs=True):
        B, P, C = 6, 3, 2
        i32 = dict(dtype=torch.int32, device="cuda")
        plan = type("Plan", (), dict(B=B, C=C, pt_start=torch.zeros(P + 1, **i32)))
        f64 = dict(dtype=torch.float64, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kn.segment_spread_sum(torch.zeros(B, 27, **f64), torch.zeros(B, **i32),
                                  torch.zeros(P + 1, **i32), C, 3, 9,
                                  Jc=torch.zeros(B, 18, **f64), r=2, plan=plan)
    assert all(k.plain_calls == 0 and k.launches == 0 for k in kn.KERNELS)


def test_eval_fused_variants_given_cuda_tensors_do_not_run_the_plain_version(
        monkeypatch):
    """eval_fused with a loss (row 1L) and with quaternion cameras (row 1Q),
    as above: on (fake) CUDA tensors each goes to the kernel and raises
    without a toolkit; a residual the kernel does not compute raises
    too, and no plain version runs in its place."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ceres_tpu_torch import loss as tloss
    from ceres_tpu_torch.ops import build

    def no_toolkit():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "find_nvcc", no_toolkit)
    kn.reset_counts()
    huber = tloss.flatten_loss(ctt.HuberLoss(1.0))
    with FakeTensorMode(allow_non_fake_inputs=True):
        B, P, C = 6, 3, 2
        i32 = dict(dtype=torch.int32, device="cuda")
        plan = type("Plan", (), dict(B=B, P=P, C=C, cam_idx=torch.zeros(B, **i32),
                                     pt_idx=torch.zeros(B, **i32)))
        f64 = dict(dtype=torch.float64, device="cuda")
        pts, obs = torch.zeros(P, 3, **f64), torch.zeros(B, 2, **f64)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kn.eval_fused(torch.zeros(C, 9, **f64), pts, obs, plan,
                          tbal.snavely_residual_rows, huber)
        for loss in (None, huber):
            with pytest.raises(RuntimeError, match="nvcc not found"):
                kn.eval_fused(torch.zeros(C, 10, **f64), pts, obs, plan,
                              tbal.snavely_quat_residual_rows, loss)
        with pytest.raises(ValueError, match="flat path"):
            kn.eval_fused(torch.zeros(C, 9, **f64), pts, obs, plan,
                          lambda c, p, o: tbal.snavely_residual_rows(c, p, o))
    assert all(k.plain_calls == 0 and k.launches == 0 for k in kn.KERNELS)


def test_kernel_wrapper_checks_its_inputs():
    """A wrong dtype or shape is refused before anything runs."""
    b = tbal.synthetic_bal(num_cameras=3, num_points=20, visibility=0.6, seed=2)
    from ceres_tpu_torch.ops.flatops import build_row_plan

    order = np.argsort(b.point_index, kind="stable")
    plan = build_row_plan(b.point_index[order], b.camera_index[order],
                          b.num_points, b.num_cameras, "cpu", n_cams=b.num_cameras)
    assert kn._on_cpu(torch.zeros(1))
    with pytest.raises(ValueError, match="no kernel for device"):
        kn._on_cpu(torch.zeros(1, device="meta"))
    with pytest.raises(TypeError, match="dtype"):
        kn._check(torch.zeros(3, dtype=torch.float32), "x", torch.float64, (3,),
                  torch.device("cpu"))
    with pytest.raises(ValueError, match="shape"):
        kn._check(torch.zeros(4), "x", torch.float32, (3,), torch.device("cpu"))
    kn._check_plan(plan, torch.device("cpu"))
