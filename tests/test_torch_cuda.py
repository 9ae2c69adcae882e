"""Card-only tests of ceres_tpu_torch: each CUDA kernel against its plain
version on the card, and the card's solve against the CPU's. They carry
the `cuda` marker and skip without a CUDA device. This file imports
neither jax nor ceres_tpu, so on a machine with a card it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.ops import kernels as kn
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.solvers.fused_lm import DenseSchurStepOps, JTForm

pytestmark = pytest.mark.cuda

REL_LIMIT = {torch.float64: 1e-11, torch.float32: 1e-4}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def small_bal():
    return tbal.perturb(tbal.synthetic_bal(num_cameras=6, num_points=400,
                                           visibility=0.5, seed=5),
                        0.01, 0.05, 0.05, seed=1)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["eval_fused", "post_eval_fused",
                                  "schur_assembly", "normal_matvec"])
def test_kernel_matches_plain_on_card(card, name, dtype):
    """Kernel and plain version on the same card inputs, relative to each
    output's largest entry: 1e-11 in float64, 1e-4 in float32 (by the
    working dtype; the cost is a float64 sum in both)."""
    prog = CompiledProgram(tbal.build_problem_batched(small_bal())[0], dtype,
                           device=card)
    opts = ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR)
    ops = DenseSchurStepOps(prog, opts, [1])
    plan, q, dt = ops.flat.plan, ops._jt_qual, prog.compute_dtype
    x = prog.initial_state()
    cams = prog.family_table(x, q.fam_f).to(dt).contiguous()
    pts = prog.family_table(x, q.fam_e).to(dt).contiguous()
    obs = prog.kinds[0].data
    _, rT, JT = kn.eval_fused_plain(cams, pts, obs, plan, q.rows_fn)
    g, sqn, aux = ops.post_eval(JTForm(JT, rT))
    scale = (1.0 / (1.0 + torch.sqrt(sqn.double()))).to(dt)
    D2 = (torch.clamp(scale.double() ** 2 * sqn.double(), 1e-6, 1e32) / 1e4).to(dt)
    _, se, sf, _, K, u = ops.schur_inputs(aux, g, scale, D2)
    P, C = plan.P, plan.C
    args = {
        "eval_fused": (cams, pts, obs, plan, q.rows_fn),
        "post_eval_fused": (JT, rT, plan),
        "schur_assembly": (JT, sf.reshape(C, 9).contiguous(),
                           se.reshape(P, 3).contiguous(), K.contiguous(),
                           u.reshape(P, 3).contiguous(), plan),
        "normal_matvec": (JT, torch.ones((C, 9), dtype=dt, device=card),
                          torch.ones((P, 3), dtype=dt, device=card), plan),
    }[name]
    wrapper, plain = getattr(kn, name), getattr(kn, name + "_plain")
    kn.reset_counts()
    out = wrapper(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    assert wrapper.launches == 1 and wrapper.plain_calls == 0
    for o, r in zip(out, ref):
        err = (o.double() - r.double()).abs().max().item()
        assert err <= REL_LIMIT[dt] * r.double().abs().max().item()


def test_schur_assembly_beyond_shared_memory_on_card(card):
    """120 cameras: t_full = 1080, an AtA of 9.3 MB in float64, far past
    one block's shared memory (the JAX package takes this path up to
    t_full = 1024). Kernel against plain version at 1e-11."""
    b = tbal.perturb(tbal.synthetic_bal(num_cameras=120, num_points=2000,
                                        visibility=0.04, seed=6),
                     0.01, 0.05, 0.05, seed=1)
    prog = CompiledProgram(tbal.build_problem_batched(b)[0], "float64",
                           device=card)
    opts = ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR)
    ops = DenseSchurStepOps(prog, opts, [1])
    plan = ops.flat.plan
    _, vrep = ops.evaluate(prog.initial_state())
    P, C = plan.P, plan.C
    rng = np.random.default_rng(1)
    rand = lambda *shape: torch.as_tensor(rng.uniform(0.5, 1.5, shape), device=card)
    args = (vrep.jt, rand(C, 9), rand(P, 3),
            torch.tril(rand(P, 3, 3)).reshape(P, 9).contiguous(), rand(P, 3), plan)
    out = kn.schur_assembly(*args)
    torch.cuda.synchronize()
    ref = kn.schur_assembly_plain(*args)
    assert out[0].shape == (1080, 1080)
    for o, r in zip(out, ref):
        assert (o - r).abs().max().item() <= 1e-11 * r.abs().max().item()


def test_solve_on_card_matches_cpu(card):
    """The same solve on the card (kernels) and on the CPU (plain
    versions): the same trajectory, costs and radii to 1e-9 relative.
    Each solve gets its own copy of the arrays it writes back into."""
    b = small_bal()
    arrays = (b.cameras, b.points, b.camera_index, b.point_index, b.observations)
    opts = ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR)
    ref = ctt.solve(opts, tbal.build_problem_batched(tbal.from_arrays(*arrays))[0],
                    device="cpu")
    kn.reset_counts()
    out = ctt.solve(opts, tbal.build_problem_batched(tbal.from_arrays(*arrays))[0])
    n_it = len(out.iterations) - 1
    assert all(k.launches >= n_it and k.plain_calls == 0 for k in kn.KERNELS)
    assert out.termination_type == ref.termination_type
    assert len(out.iterations) == len(ref.iterations)
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9)
        assert c.trust_region_radius == pytest.approx(a.trust_region_radius, rel=1e-9)
    assert np.isfinite(out.final_cost)
