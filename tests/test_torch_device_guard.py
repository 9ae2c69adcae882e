"""Every kernel of ceres_tpu_torch/ops/kernels.py launches with its
tensors' device current. A C entry point launches on the calling thread's
current device, whatever device its stream belongs to, so each wrapper
and both occupancy queries call their entry point only through
kernels._launch, which enters kernels._device_guard (torch.cuda.device on
a card). Here the wrappers run their kernel path on CPU tensors with the
entry points replaced by stand-ins that record which device the guard
had made current when they were called: no card and no build needed."""
import contextlib
import ctypes

import numpy as np
import pytest
import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.ops import flatops as fo
from ceres_tpu_torch.ops import kernels as kn
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.solvers.fused_lm import DenseSchurStepOps


class _Guard:
    """A stand-in for kernels._device_guard: the device it made current."""

    def __init__(self):
        self.current = None

    @contextlib.contextmanager
    def __call__(self, dev):
        prev, self.current = self.current, dev
        try:
            yield
        finally:
            self.current = prev


@pytest.fixture
def entry_calls(monkeypatch):
    """[(entry point, the device current when it was called)], for the
    wrappers' kernel path on CPU tensors."""
    guard, calls = _Guard(), []

    def entry(name, dtype):
        def fn(*args):
            calls.append((name, guard.current))
            return 0
        fn.__name__ = name
        return fn

    monkeypatch.setattr(kn, "_device_guard", guard)
    monkeypatch.setattr(kn, "_entry", entry)
    monkeypatch.setattr(kn, "_stream", lambda dev: ctypes.c_void_p(0))
    monkeypatch.setattr(kn, "_on_cpu", lambda ref: False)
    monkeypatch.setattr(kn, "_RESIDENT", {})
    monkeypatch.setattr(kn, "_DONE", {})
    # a CPU tensor's device has no index: the occupancy query asks for one
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return calls


def _jt_args():
    """The jt kernels' arguments at the start of a 5-camera BAL problem,
    its quaternion twin and a Huber loss."""
    out = {}
    for model, build, loss in (("aa", tbal.build_problem_batched, None),
                               ("loss", tbal.build_problem_batched, ctt.HuberLoss(1.0)),
                               ("quat", tbal.build_problem_batched_quat, None)):
        b = tbal.perturb(tbal.synthetic_bal(num_cameras=5, num_points=40, visibility=0.6,
                                            seed=4), 0.01, 0.05, 0.05, seed=1)
        prog = CompiledProgram(build(b, loss)[0], device="cpu")
        ops = DenseSchurStepOps(
            prog, ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR), [1])
        q, x = ops._jt_qual, prog.initial_state()
        cams = prog.family_table(x, q.fam_f).contiguous()
        pts = prog.family_table(x, q.fam_e).contiguous()
        out[model] = (cams, pts, prog.kinds[0].data, ops.flat.plan, q.rows_fn, q.loss)
    plan = out["aa"][3]
    _, rT, JT = kn.eval_fused_plain(*out["aa"][:5])
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.as_tensor(rng.uniform(0.5, 1.5, shape))

    P, C = plan.P, plan.C
    return {
        "eval_fused": out["aa"][:5],
        "eval_fused_loss": out["loss"],
        "eval_fused_quat": out["quat"][:5],
        "post_eval_fused": (JT, rT, plan),
        "schur_assembly": (JT, rand(C, 9), rand(P, 3), rand(P, 9), rand(P, 3), plan),
        "normal_matvec": (JT, rand(C, 9), rand(P, 3), plan),
        "isc_matvec": (JT, rand(C, 9), rand(P, 9), plan, True),
        "schur_jacobi_blocks": (JT, rand(P, 3), rand(P, 9), plan),
    }


def _flat_args():
    rng = np.random.default_rng(1)
    n, K = 300, 20
    sorted_plan = fo.build_segment_plan(np.sort(rng.integers(0, K, n)), K, "cpu")
    unsorted_plan = fo.build_segment_plan(rng.integers(0, K, n), K, "cpu")
    C, B = 4, 150
    pt = np.sort(rng.integers(0, 12, B))
    cam = rng.integers(0, C, B)
    rows = fo.build_row_plan(pt, cam, 12, C, "cpu", n_cams=C)
    Y = torch.as_tensor(rng.standard_normal((B, 27)))
    return {
        "segment_block_sum": (torch.as_tensor(rng.standard_normal((n, 3))), sorted_plan),
        "unsorted_segment_sum": (torch.as_tensor(rng.standard_normal((n, 6))),
                                 unsorted_plan),
        "segment_block_expand": (torch.as_tensor(rng.standard_normal((K, 9))),
                                 sorted_plan.ids),
        "segment_spread_sum": (Y, rows.cam_idx, rows.pt_start, C, 3, 9),
        "segment_spread_ftf": (Y, rows.cam_idx, rows.pt_start, C, 3, 9,
                               torch.as_tensor(rng.standard_normal((B, 18))), 2, rows),
    }


# each wrapper's C entry points: segment_block_sum first asks the card how
# many blocks of its staged pass it holds
ENTRIES = {
    "eval_fused": ["ct_eval_fused"], "eval_fused_loss": ["ct_eval_fused"],
    "eval_fused_quat": ["ct_eval_fused"], "post_eval_fused": ["ct_post_eval_fused"],
    "schur_assembly": ["ct_schur_assembly"], "normal_matvec": ["ct_normal_matvec"],
    "isc_matvec": ["ct_isc_matvec"], "schur_jacobi_blocks": ["ct_schur_jacobi"],
    "segment_block_sum": ["ct_segment_block_sum_resident", "ct_segment_block_sum"],
    "unsorted_segment_sum": ["ct_unsorted_segment_sum"],
    "segment_block_expand": ["ct_segment_block_expand"],
    "segment_spread_sum": ["ct_segment_spread_sum"],
    "segment_spread_ftf": ["ct_segment_spread_ftf"],
}


def test_every_kernel_is_in_the_table():
    assert sorted(ENTRIES) == sorted(k.__name__ for k in kn.KERNELS)


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_each_wrapper_launches_with_its_tensors_device_current(entry_calls, name):
    args = (_flat_args() if name.startswith("segment") or name == "unsorted_segment_sum"
            else _jt_args())[name]
    kn.reset_counts()
    wrapper = getattr(kn, name)
    wrapper(*args)
    assert wrapper.launches == 1 and wrapper.plain_calls == 0
    assert [c[0] for c in entry_calls] == ENTRIES[name]
    assert all(dev == args[0].device for _, dev in entry_calls), entry_calls


@pytest.mark.parametrize("query,args", [
    ("eval_fused_occupancy", (torch.float64, kn.MODEL_SNAVELY, False)),
    ("_resident_blocks", (torch.float32, 15))])
def test_occupancy_queries_ask_the_card_they_are_given(entry_calls, query, args):
    """cudaOccupancyMaxActiveBlocksPerMultiprocessor asks the current
    device: both queries make the card they are given current first."""
    dev = torch.device("cuda", 2)
    getattr(kn, query)(dev, *args)
    assert [d for _, d in entry_calls] == [dev]


def test_launch_enters_the_tensors_card(monkeypatch):
    """On a card the guard is torch.cuda.device(dev), entered around the
    entry point's call: it is made here without touching a card."""
    guard = kn._device_guard(torch.device("cuda", 1))
    assert isinstance(guard, torch.cuda.device) and guard.idx == 1
    assert isinstance(kn._device_guard(torch.device("cpu")), contextlib.nullcontext)
    seen = []

    @contextlib.contextmanager
    def device(dev):
        seen.append(("enter", dev))
        yield
        seen.append(("exit", dev))

    def fn(*args):
        seen.append(("call", args))
        return 0

    monkeypatch.setattr(torch.cuda, "device", device)
    dev = torch.device("cuda", 3)
    kn._launch(fn, dev, 7)
    assert seen == [("enter", dev), ("call", (7,)), ("exit", dev)]

    def failing(*args):
        return 700

    with pytest.raises(RuntimeError, match="CUDA error 700"):
        kn._launch(failing, dev)
