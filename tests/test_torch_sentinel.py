"""Constant blocks through the kernels: the row plan of a
program with a constant camera (the sentinel: a camera id of C or more)
and each kernel's plain version at such a plan, against the same sums
with the constant camera's rows taken out of every camera-side sum (and
its camera step zero on the point side); the flat path's segment sums
and gather with a sentinel key. The CUDA kernels at these inputs run in
tests/test_torch_kernels_emulated.py and on the card in chip_smoke.py."""
import numpy as np
import pytest
import torch

import chip_smoke
import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.ops import flatops as fo
from ceres_tpu_torch.ops import kernels as kn
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.solvers.fused_lm import DenseSchurStepOps

LIMIT = 1e-12


def gauge_fixed_program(num_cameras=5, num_points=80, constant=(0,)):
    b = tbal.perturb(tbal.synthetic_bal(num_cameras=num_cameras, num_points=num_points,
                                        visibility=0.5, seed=4), 0.01, 0.05, 0.05, seed=1)
    p, cams, _ = chip_smoke.gauge_fixed_problem(tbal, b, constant)
    return CompiledProgram(p, device="cpu")


def jt_inputs(prog, seed=0):
    """The plan, lanes and random camera/point operands of the jt kernels."""
    ops = DenseSchurStepOps(prog, ctt.Options(), [1])
    plan, q = ops.flat.plan, ops._jt_qual
    x = prog.initial_state()
    cams = prog.family_table(x, q.fam_f).contiguous()
    pts = prog.family_table(x, q.fam_e).contiguous()
    _, rT, JT = kn.eval_fused_plain(cams, pts, prog.kinds[0].data, plan, q.rows_fn)
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.as_tensor(rng.uniform(0.5, 1.5, shape))

    P, C = plan.P, plan.C
    A = rand(P, 3, 3)
    return dict(plan=plan, JT=JT, rT=rT, xc=rand(C, 9), xp=rand(P, 3),
                sp=rand(P, 3), K=torch.tril(rand(P, 3, 3)).reshape(P, 9),
                u=rand(P, 3), minv=(A @ A.transpose(1, 2)).reshape(P, 9))


def full_plan(plan):
    """The same rows with every camera variable: the constant cameras'
    table rows become cameras C .. n_cams - 1."""
    return fo.build_row_plan(plan.pt_idx.numpy(), plan.cam_idx.numpy(), plan.P,
                             plan.n_cams, "cpu", n_cams=plan.n_cams)


def zero_pad(t, n):
    return torch.cat([t, t.new_zeros((n - t.shape[0],) + tuple(t.shape[1:]))])


def test_row_plan_leaves_the_sentinel_out_of_the_camera_plans():
    """Rows of the constant camera: cam_pos -1, no run that reaches a
    camera, no pair; every other row in camera order as without it."""
    prog = gauge_fixed_program()
    plan = jt_inputs(prog)["plan"]
    cam = plan.cam_idx.numpy()
    sent = cam >= plan.C
    assert sent.any() and plan.n_cams == plan.C + 1
    pos = plan.cam_pos.numpy()
    assert np.all(pos[sent] == -1)
    np.testing.assert_array_equal(np.sort(pos[~sent]), np.arange((~sent).sum()))
    assert int(plan.cam_levels[0][-1]) == (~sent).sum()
    run_cam = cam[plan.run_slot.numpy().argsort()][plan.run_start.numpy()[:-1]]
    rp = plan.run_pos.numpy()
    assert np.all(rp[run_cam >= plan.C] == -1) and np.all(rp[run_cam < plan.C] >= 0)
    pairs = plan.ensure_pairs()
    assert np.all(cam[pairs.pair_a.numpy()] < plan.C)
    assert np.all(cam[pairs.pair_b.numpy()] < plan.C)


def test_row_plan_rejects_ids_out_of_range():
    with pytest.raises(ValueError, match="camera is out of range"):
        fo.build_row_plan(np.array([0, 1]), np.array([0, 3]), 2, 2, "cpu", n_cams=3)
    with pytest.raises(ValueError, match="point is out of range"):
        fo.build_row_plan(np.array([0, 2]), np.array([0, 1]), 2, 2, "cpu", n_cams=2)
    with pytest.raises(ValueError, match="camera table"):
        fo.build_row_plan(np.array([0, 1]), np.array([0, 0]), 2, 2, "cpu", n_cams=1)


def test_check_plan_rejects_a_short_camera_table():
    plan = fo.build_row_plan(np.array([0, 1]), np.array([0, 2]), 2, 2, "cpu", n_cams=3)
    plan.n_cams = 1
    with pytest.raises(ValueError, match="camera table"):
        kn._check_plan(plan, torch.device("cpu"))


@pytest.mark.parametrize("constant", [(0,), (1, 3)])
def test_eval_and_post_eval_with_the_sentinel(constant):
    """Row 1 reads each constant camera from the camera table (the
    residuals and lanes of the same rows with every camera variable);
    row 2's point sums take every row, its camera sums those of the
    variable cameras only."""
    inp = jt_inputs(gauge_fixed_program(constant=constant))
    plan, JT, rT = inp["plan"], inp["JT"], inp["rT"]
    full = full_plan(plan)
    ptab, cam = kn.post_eval_fused_plain(JT, rT, plan)
    ptab_f, cam_f = kn.post_eval_fused_plain(JT, rT, full)
    torch.testing.assert_close(ptab, ptab_f, rtol=LIMIT, atol=0)
    torch.testing.assert_close(cam, cam_f[:plan.C], rtol=LIMIT, atol=0)
    keep = plan.cam_idx < plan.C
    removed = fo.build_row_plan(plan.pt_idx[keep].numpy(), plan.cam_idx[keep].numpy(),
                                plan.P, plan.C, "cpu", n_cams=plan.C)
    _, cam_r = kn.post_eval_fused_plain(JT[:, keep].contiguous(), rT[:, keep].contiguous(),
                                        removed)
    torch.testing.assert_close(cam, cam_r, rtol=LIMIT, atol=1e-300)


@pytest.mark.parametrize("constant", [(0,), (1, 3)])
def test_matvecs_and_assemblies_with_the_sentinel(constant):
    """Rows 3, 3b, 4, 4b: a constant camera's rows add to the point side
    with no camera step (x_c, z and the camera scales zero there) and to
    no camera-side sum: the outputs of the same rows with every camera
    variable and the constant ones' inputs zero, cut to the C cameras."""
    inp = jt_inputs(gauge_fixed_program(constant=constant))
    plan, JT = inp["plan"], inp["JT"]
    full, n, C = full_plan(plan), plan.n_cams, plan.C
    xc_f = zero_pad(inp["xc"], n)
    cam, pt = kn.normal_matvec_plain(JT, inp["xc"], inp["xp"], plan)
    cam_f, pt_f = kn.normal_matvec_plain(JT, xc_f, inp["xp"], full)
    torch.testing.assert_close(pt, pt_f, rtol=LIMIT, atol=0)
    torch.testing.assert_close(cam, cam_f[:C], rtol=LIMIT, atol=0)
    cam, u = kn.isc_matvec_plain(JT, inp["xc"], inp["minv"], plan, True)
    cam_f, u_f = kn.isc_matvec_plain(JT, xc_f, inp["minv"], full, True)
    torch.testing.assert_close(u, u_f, rtol=LIMIT, atol=0)
    torch.testing.assert_close(cam, cam_f[:C], rtol=LIMIT, atol=0)
    blocks = kn.schur_jacobi_blocks_plain(JT, inp["sp"], inp["minv"], plan)
    blocks_f = kn.schur_jacobi_blocks_plain(JT, inp["sp"], inp["minv"], full)
    torch.testing.assert_close(blocks, blocks_f[:C], rtol=LIMIT, atol=0)
    ata, ftf, U = kn.schur_assembly_plain(JT, inp["xc"], inp["sp"], inp["K"], inp["u"],
                                          plan)
    ata_f, ftf_f, U_f = kn.schur_assembly_plain(JT, xc_f, inp["sp"], inp["K"], inp["u"],
                                                full)
    torch.testing.assert_close(ata, ata_f[:9 * C, :9 * C], rtol=LIMIT, atol=0)
    torch.testing.assert_close(ftf, ftf_f[:C], rtol=LIMIT, atol=0)
    torch.testing.assert_close(U, U_f[:9 * C], rtol=LIMIT, atol=0)


@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_sums_and_gather_with_a_sentinel_key(sorted_ids):
    """Rows 6 and 9 with the sentinel key nv of a slot plan (a constant
    block in a variable family): the first nv keys are the sums of the
    rows of the variable blocks alone; row 7 gathers zero for the
    sentinel from a table with its zero last row."""
    rng = np.random.default_rng(2)
    nv = 7
    ids = rng.integers(0, nv + 1, 300)
    if sorted_ids:
        ids = np.sort(ids)
    plan = fo.build_segment_plan(ids, nv + 1, "cpu")
    contrib = torch.as_tensor(rng.standard_normal((300, 9)))
    out = (kn.segment_block_sum_plain if sorted_ids else kn.unsorted_segment_sum_plain)(
        contrib, plan)
    keep = ids < nv
    ref = torch.zeros((nv, 9), dtype=torch.float64).index_add_(
        0, torch.as_tensor(ids[keep]), contrib[torch.as_tensor(keep)])
    torch.testing.assert_close(out[:nv], ref, rtol=LIMIT, atol=0)
    table = torch.cat([torch.as_tensor(rng.standard_normal((nv, 9))),
                       torch.zeros((1, 9), dtype=torch.float64)])
    got = kn.segment_block_expand_plain(table, plan.ids)
    assert torch.all(got[torch.as_tensor(~keep)] == 0)
    torch.testing.assert_close(got[torch.as_tensor(keep)], table[torch.as_tensor(ids[keep])])


def test_constant_family_gets_no_flat_plan():
    """A constant array (libmv's intrinsics with refine_intrinsics=False)
    is in no flat plan: no segment sum, gather or product touches it."""
    from ceres_tpu_torch.models import libmv as tlibmv
    from ceres_tpu_torch.ops import bsr
    from ceres_tpu_torch.ops import partition as pt
    from ceres_tpu_torch.utils import ordering
    from test_torch_libmv import small_libmv

    prog = CompiledProgram(tlibmv.build_problem(chip_smoke.fresh(small_libmv()),
                                                refine_intrinsics=False)[0], device="cpu")
    assert [f.num_var for f in prog.families][-1] == 0
    pm = pt.build_partition(bsr.build_meta(prog), ordering.eligible_e_sets(prog))
    flat = fo.FlatSchurOps(pm, prog)
    assert [p.s for p in flat.plans_f[0]] == [0]
    assert [p.s for p in flat.plans_e[0]] == [1]
