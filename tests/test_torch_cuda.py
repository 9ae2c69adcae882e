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
from ceres_tpu_torch.ops import flatops as fo
from ceres_tpu_torch.ops import kernels as kn
from ceres_tpu_torch.ops import partition as pt
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.solvers.fused_lm import (
    DenseSchurStepOps,
    IterativeSchurStepOps,
    JTForm,
)

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
    # exactly symmetric, and the same bits again (no atomics)
    ftf = out[1].reshape(-1, 9, 9)
    assert torch.equal(out[0], out[0].T) and torch.equal(ftf, ftf.transpose(1, 2))
    assert all(torch.equal(a, o) for a, o in zip(kn.schur_assembly(*args), out))


def test_solve_on_card_matches_cpu(card):
    """The same solve on the card (kernels) and on the CPU (plain
    versions): the same trajectory, costs and radii to 1e-9 relative.
    Each solve gets its own copy of the arrays it writes back into."""
    b = small_bal()
    arrays = (b.cameras, b.points, b.camera_index, b.point_index, b.observations)
    opts = ctt.Options(fused_loop="ALWAYS", linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR)
    ref = ctt.solve(opts, tbal.build_problem_batched(tbal.from_arrays(*arrays))[0],
                    device="cpu")
    kn.reset_counts()
    out = ctt.solve(opts, tbal.build_problem_batched(tbal.from_arrays(*arrays))[0])
    n_it = len(out.iterations) - 1
    assert all(k.launches >= n_it and k.plain_calls == 0 for k in
               (kn.eval_fused, kn.post_eval_fused, kn.schur_assembly,
                kn.normal_matvec))
    assert out.termination_type == ref.termination_type
    assert len(out.iterations) == len(ref.iterations)
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9)
        assert c.trust_region_radius == pytest.approx(a.trust_region_radius, rel=1e-9)
    assert np.isfinite(out.final_cost)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["isc_matvec", "isc_matvec_no_u",
                                  "schur_jacobi_blocks"])
def test_iterative_kernel_matches_plain_on_card(card, name, dtype):
    """The iterative-Schur kernels at a Venice-shaped instance of 300
    cameras (more cameras than a block has threads) against their plain
    versions on the same card inputs: 1e-11 in float64, 1e-4 in float32,
    relative to each output's largest entry."""
    b = tbal.synthetic_bal_large(num_cameras=300, num_points=5000, cam_window=20,
                                 seed=2)
    prog = CompiledProgram(tbal.build_problem_batched(b)[0], dtype, device=card)
    ops = IterativeSchurStepOps(
        prog, ctt.Options(linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR),
        [1])
    plan = ops.flat.plan
    _, vrep = ops.evaluate(prog.initial_state())
    _, sqn, (ete,) = ops.post_eval(vrep)
    scale = (1.0 / (1.0 + torch.sqrt(sqn.double()))).to(prog.compute_dtype)
    se = pt.extract_e(ops.pm, scale)
    P, C = plan.P, plan.C
    minv = fo.scaled_block_inverses(ete, se, torch.ones_like(se), 3)
    z = torch.ones((C, 9), dtype=prog.compute_dtype, device=card)
    args = {"isc_matvec": (vrep.jt, z, minv, plan, True),
            "isc_matvec_no_u": (vrep.jt, z, minv, plan, False),
            "schur_jacobi_blocks": (vrep.jt, se.reshape(P, 3).contiguous(), minv,
                                    plan)}[name]
    name = name.replace("_no_u", "")
    wrapper, plain = getattr(kn, name), getattr(kn, name + "_plain")
    kn.reset_counts()
    out = wrapper(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    assert wrapper.launches == 1 and wrapper.plain_calls == 0
    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
    for o, r in zip(out, ref):
        if r is None:
            assert o is None
            continue
        err = (o.double() - r.double()).abs().max().item()
        assert err <= REL_LIMIT[prog.compute_dtype] * r.double().abs().max().item()


def test_iterative_solve_on_card_matches_cpu(card):
    """ITERATIVE_SCHUR + SCHUR_JACOBI on the card and on the CPU: the same
    rows and CG counts, costs and radii to 1e-9 relative; the five kernels
    of the path launch, the dense assembly does not."""
    b = small_bal()
    arrays = (b.cameras, b.points, b.camera_index, b.point_index, b.observations)
    opts = ctt.Options(fused_loop="ALWAYS", linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR)
    ref = ctt.solve(opts, tbal.build_problem_batched(tbal.from_arrays(*arrays))[0],
                    device="cpu")
    kn.reset_counts()
    out = ctt.solve(opts, tbal.build_problem_batched(tbal.from_arrays(*arrays))[0])
    n_it = len(out.iterations) - 1
    assert kn.schur_assembly.launches == 0
    for k in (kn.eval_fused, kn.post_eval_fused, kn.normal_matvec, kn.isc_matvec,
              kn.schur_jacobi_blocks):
        assert k.launches >= n_it and k.plain_calls == 0, k.__name__
    assert ([r.linear_solver_iterations for r in out.iterations]
            == [r.linear_solver_iterations for r in ref.iterations])
    assert out.termination_type == ref.termination_type
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9)
        assert c.trust_region_radius == pytest.approx(a.trust_region_radius, rel=1e-9)


def _isc_long_inputs(card, dtype, emit_u):
    """isc_matvec's arguments on a row plan that reaches every branch of
    the redesigned kernel (tests/test_torch_kernels_emulated.py's, ten
    times the points): tracks of 600 and 1,000 rows (blocks that loop),
    points without rows, and a camera of ~40,000 rows (a second camera
    level)."""
    rng = np.random.default_rng(11)
    P, C = 15000, 7
    counts = rng.integers(1, 6, P)
    counts[17], counts[3], counts[1400], counts[9000] = 600, 0, 0, 1000
    pt = np.repeat(np.arange(P), counts)
    B = pt.shape[0]
    cam = np.where(rng.uniform(size=B) < 0.85, 0, rng.integers(1, C, B))
    plan = fo.build_row_plan(pt, cam, P, C, card, n_cams=C)
    assert len(plan.cam_levels) == 2
    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    JT = torch.as_tensor(rng.standard_normal((kn.LANES, B)), device=card).to(dt)
    z = torch.as_tensor(rng.standard_normal((C, 9)), device=card).to(dt)
    A = rng.standard_normal((P, 3, 3))
    minv = torch.as_tensor((A @ A.transpose(0, 2, 1)).reshape(P, 9), device=card).to(dt)
    return JT, z, minv, plan, emit_u


@pytest.mark.parametrize("emit_u", [True, False], ids=["isc_matvec", "isc_matvec_no_u"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_isc_matvec_long_track_and_large_camera_on_card(card, dtype, emit_u):
    """The looping point blocks and the second camera level of
    csrc/isc_matvec.cu against the plain version on the same card inputs,
    relative to each output's largest entry: 1e-11 in float64, 1e-4 in
    float32; a second call gives the same bits (no atomics)."""
    args = _isc_long_inputs(card, dtype, emit_u)
    kn.reset_counts()
    cam, u = kn.isc_matvec(*args)
    torch.cuda.synchronize()
    cam_ref, u_ref = kn.isc_matvec_plain(*args)
    assert kn.isc_matvec.launches == 1 and kn.isc_matvec.plain_calls == 0
    for o, r in ((cam, cam_ref), (u, u_ref)) if emit_u else ((cam, cam_ref),):
        err = (o.double() - r.double()).abs().max().item()
        assert err <= REL_LIMIT[o.dtype] * r.double().abs().max().item()
    assert torch.equal(kn.isc_matvec(*args)[0], cam)


def _point_block_inputs(card, name, dtype):
    """normal_matvec's, post_eval_fused's or schur_jacobi_blocks' arguments
    on a row plan that reaches every branch of csrc/point_blocks.cuh at the
    real chunk: tracks of 256 (a full block), 600 and 1,000 rows (blocks
    that loop), points without rows and of one row, a ragged last block, and
    a camera of about a million rows in 4,722 tiles (three levels of its sum
    by rows, two by runs); 1.2M rows in all."""
    rng = np.random.default_rng(17)
    P, C = 400_000, 7
    counts = rng.integers(1, 6, P)
    counts[17], counts[3], counts[1400], counts[9000], counts[500] = 600, 0, 0, 1000, 256
    pt = np.repeat(np.arange(P), counts)
    B = pt.shape[0]
    cam = np.where(rng.uniform(size=B) < 0.85, 0, rng.integers(1, C, B))
    plan = fo.build_row_plan(pt, cam, P, C, card, n_cams=C)
    assert len(plan.cam_levels) == 3 and len(plan.run_levels) == 2
    assert B % kn.POINT_BLOCK
    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), device=card).to(dt)

    if name == "post_eval_fused":
        return rand(kn.LANES, B), rand(kn.R, B), plan
    if name == "schur_jacobi_blocks":
        se = torch.as_tensor(rng.uniform(0.5, 1.5, (P, 3)), device=card).to(dt)
        A = rng.standard_normal((P, 3, 3))
        minv = (A @ A.transpose(0, 2, 1) + np.eye(3)).reshape(P, 9)
        return rand(kn.LANES, B), se, torch.as_tensor(minv, device=card).to(dt), plan
    return rand(kn.LANES, B), rand(C, 9), rand(P, 3), plan


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["normal_matvec", "post_eval_fused", "schur_jacobi_blocks"])
def test_point_block_kernel_long_tracks_and_deep_camera_on_card(card, name, dtype):
    """csrc/normal_matvec.cu, csrc/post_eval_fused.cu and
    csrc/schur_jacobi.cu against the plain version in float64 on the same
    card inputs (a float32 sum by atomics over a million rows is no
    reference), relative to each output's largest entry: 1e-11 in float64,
    1e-4 in float32; one launch for the call; a second call gives the same
    bits (no atomics); block-diag(S)'s blocks exactly symmetric."""
    args = _point_block_inputs(card, name, dtype)
    wrapper, plain = getattr(kn, name), getattr(kn, name + "_plain")
    kn.reset_counts()
    out = wrapper(*args)
    torch.cuda.synchronize()
    ref = plain(*(a.double() if isinstance(a, torch.Tensor) else a for a in args))
    assert wrapper.launches == 1 and wrapper.plain_calls == 0
    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
        blocks = out[0].reshape(-1, 9, 9)
        assert torch.equal(blocks, blocks.transpose(1, 2))
    for o, r in zip(out, ref):
        err = (o.double() - r.double()).abs().max().item()
        assert err <= REL_LIMIT[o.dtype] * r.double().abs().max().item()
    again = wrapper(*args)
    again = again if isinstance(again, tuple) else (again,)
    assert all(torch.equal(a, o) for a, o in zip(again, out))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("t", [1, 3, 6, 8, 9, 13])
def test_segment_block_expand_widths_on_card(card, dtype, t):
    """segment_block_expand at every width the port launches (3, 6, 8, 9:
    the templated kernels) and two it does not (1, 13: the generic one), ids
    in no order with the sentinel among them, N no multiple of a block's
    rows: exactly the plain version."""
    rng = np.random.default_rng(t)
    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    K, N = 5001, 300_007
    vals = torch.as_tensor(rng.standard_normal((K, t)), device=card).to(dt)
    vals[-1] = 0
    ids = rng.integers(0, K, N)
    ids[::97] = K - 1
    ids = torch.as_tensor(ids.astype(np.int32), device=card)
    ref = kn.segment_block_expand_plain(vals, ids)
    kn.reset_counts()
    assert torch.equal(kn.segment_block_expand(vals, ids), ref)
    assert kn.segment_block_expand.launches == 1


def _segment_case(card, dtype, w, how, n=600_003):
    """contrib (n, w) on the card and a SegmentPlan of rows sorted by point
    ("sorted": tracks of up to 7 rows over 150,000 points, keys of no row,
    points of 3,000 and of ~70,000 rows (the last) whose runs span tiles,
    and the flat plans' sentinel key, of no row; 4,688 tiles, so the staged
    pass takes four tiles a block; "short": those tracks alone, every point
    one run) or of
    their cameras ("unsorted": 2,000 cameras, each row's camera within 40
    of its point's anchor, as the Venice shape draws them)."""
    rng = np.random.default_rng(w)
    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    P = 150_000
    counts = rng.integers(0, 8, P)
    if how != "short":
        counts[777] = 3000
        counts[-1] += n - counts.sum()
    n = int(counts.sum())
    pt = np.repeat(np.arange(P), counts)
    if how != "unsorted":
        ids, K = pt, P + 1
    else:
        ids = np.clip(pt * 2000 // P + rng.integers(-40, 41, n), 0, 1999)
        ids[::997] = 2000  # the sentinel
        K = 2001
    x = torch.as_tensor(rng.standard_normal((n, w)), device=card).to(dt)
    return x, fo.build_segment_plan(ids, K, card)


def _hold_segment_sum(name, x, plan):
    """The wrapper against its plain version (REL_LIMIT of the largest
    entry), one launch, a second call the same bits; keys of no row zero."""
    wrapper, plain = getattr(kn, name), getattr(kn, name + "_plain")
    kn.reset_counts()
    out = wrapper(x, plan)
    torch.cuda.synchronize()
    assert wrapper.launches == 1 and wrapper.plain_calls == 0
    ref = plain(x, plan)
    err = (out.double() - ref.double()).abs().max().item()
    assert err <= REL_LIMIT[x.dtype] * ref.double().abs().max().item()
    assert torch.equal(wrapper(x, plan), out)
    empty = torch.bincount(plan.ids.long(), minlength=plan.num_keys) == 0
    assert bool((out[empty] == 0).all())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("w", [3, 6, 8, 15, 48, 80, 5, 36])
@pytest.mark.parametrize("how", ["sorted", "short", "unsorted"])
def test_segment_sums_every_width_on_card(card, how, w, dtype):
    """Rows 6 and 9 (csrc/segment_sum.cu) at every templated width (3, 6,
    8, 15, 48, 80) and two runtime ones (5, 36), as
    test_emulated_segment_sums_every_width (tests/test_torch_kernels_emulated.py)
    at 600,003 rows ("short": ~525,000, the tile pass alone)."""
    x, plan = _segment_case(card, dtype, w, how)
    assert plan.B % kn.SEG_TILE
    assert how == "unsorted" or (plan.n_partials > 0) == (how == "sorted")
    _hold_segment_sum("unsorted_segment_sum" if how == "unsorted" else "segment_block_sum",
                      x, plan)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("w", [8, 80])
def test_segment_sum_one_key_deep_tree_on_card(card, dtype, w):
    """One key holding every row (libmv's intrinsics) over 4,300 tiles: a
    run a tile (w = 8 staged four tiles a block), and the partials through
    two levels of chunks."""
    n = 4300 * kn.SEG_TILE - 77
    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    x = torch.randn((n, w), generator=torch.Generator(device=card).manual_seed(w),
                    device=card, dtype=dt)
    plan = fo.build_segment_plan(np.zeros(n, np.int64), 2, card)
    assert plan.n_partials == 4300 and len(plan.run_levels) == 2
    _hold_segment_sum("segment_block_sum", x, plan)


def small_libmv():
    """tests/test_torch_libmv.py's problem: 5 cameras, 120 points."""
    import chip_smoke

    b = tbal.synthetic_bal(num_cameras=5, num_points=120, visibility=1.0, seed=0)
    return chip_smoke.libmv_instance(b, tbal.perturb(b, 0.02, 0.2, 0.2, seed=1))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["segment_block_sum", "segment_block_sum_one_key",
                                  "unsorted_segment_sum", "segment_block_expand",
                                  "segment_spread_sum"])
def test_flat_kernel_matches_plain_on_card(card, name, dtype):
    """The flat path's kernels at a libmv program's first-iteration inputs
    (the post-evaluation sums of the points, of the one intrinsics block
    and of the cameras; the camera-scale gather; the cameras' A rows)
    against their plain versions on the same card inputs: 1e-11 in
    float64, 1e-4 in float32, relative to the largest entry."""
    from ceres_tpu_torch.models import libmv
    from ceres_tpu_torch.solvers.fused_lm import FlatDenseSchurStepOps

    prog = CompiledProgram(libmv.build_problem(small_libmv())[0], dtype, device=card)
    ops = FlatDenseSchurStepOps(
        prog, ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR), [1])
    fl = ops.flat
    pe = fl.plans_e[0][0]
    pcam, pintr = sorted(fl.plans_f[0], key=lambda p: -p.nv)
    _, vrep = ops.evaluate(prog.initial_state())
    rows = fl._rows(vrep.r, 0)
    if name == "segment_block_expand":
        vals = torch.ones((pcam.nv + 1, 6), dtype=prog.compute_dtype, device=card)
        args = (vals.cumsum(0), pcam.local)
    elif name == "segment_spread_sum":
        _, _, (ete, _) = ops.post_eval(vrep)
        ones = torch.ones(pe.nv * pe.t, dtype=prog.compute_dtype, device=card)
        K_e = ops._scaled_K(ete, ones, ones)
        sf = torch.ones(ops.pm.f_size, dtype=prog.compute_dtype, device=card)
        Y = next(Y for p_e, p_f, Y in ops.eliminated_rows(vrep.vflat, K_e, ones, sf)
                 if p_f is pcam)
        args = (Y.reshape(Y.shape[0], -1).contiguous(), pcam.local,
                pe.seg.seg_start[:pe.nv + 1], pcam.nv, 3, 6)
    else:
        p = {"segment_block_sum": pe, "segment_block_sum_one_key": pintr,
             "unsorted_segment_sum": pcam}[name]
        args = (fl.post_contrib(fl._jac(vrep.vflat, 0, p), rows), p.seg)
    name = name.replace("_one_key", "")
    wrapper, plain = getattr(kn, name), getattr(kn, name + "_plain")
    kn.reset_counts()
    out = wrapper(*args)
    torch.cuda.synchronize()
    ref = plain(*args)
    assert wrapper.launches == 1 and wrapper.plain_calls == 0
    err = (out.double() - ref.double()).abs().max().item()
    assert err <= REL_LIMIT[prog.compute_dtype] * ref.double().abs().max().item()


@pytest.mark.parametrize("solver", ["DENSE_SCHUR", "ITERATIVE_SCHUR"])
def test_libmv_solve_on_card_matches_cpu(card, solver):
    """The flat path on the card (its four kernels) and on the CPU (plain
    versions), float64: the same rows and CG counts, each row's cost
    within 1e-9, or 4x the CPU's own one-ulp sensitivity where that is
    larger (chip_smoke.py's card_against_cpu: an eta-forced CG that ends
    in a rejected step can amplify rounding past 1e-9; the card sums in
    another order than the CPU)."""
    import chip_smoke
    from ceres_tpu_torch.models import libmv

    lp = small_libmv()
    ulp = chip_smoke.fresh(lp)
    ulp.cameras = np.nextafter(lp.cameras, np.inf)
    opts = ctt.Options(fused_loop="ALWAYS", linear_solver_type=ctt.LinearSolverType[solver])
    ref = ctt.solve(opts, libmv.build_problem(chip_smoke.fresh(lp))[0], device="cpu")
    twin = ctt.solve(opts, libmv.build_problem(ulp)[0], device="cpu")
    kn.reset_counts()
    out = ctt.solve(opts, libmv.build_problem(chip_smoke.fresh(lp))[0])
    n_it = len(out.iterations) - 1
    flat = ["segment_block_sum", "segment_block_expand", "unsorted_segment_sum"]
    if solver == "DENSE_SCHUR":
        flat.append("segment_spread_sum")
    for k in kn.KERNELS:
        assert k.plain_calls == 0, k.__name__
        assert (k.launches >= n_it) if k.__name__ in flat else k.launches == 0, k.__name__
    assert ([r.linear_solver_iterations for r in out.iterations]
            == [r.linear_solver_iterations for r in ref.iterations])
    for a, c, u in zip(ref.iterations, out.iterations, twin.iterations):
        sens = abs(u.cost - a.cost) / abs(a.cost)
        assert c.cost == pytest.approx(a.cost, rel=max(1e-9, 4 * sens))


def _specialized_inputs(card, dtype):
    """The first iteration's inputs of kernel 8J on the specialized pipeline
    (parallel/sharded_ba.py) at a 6-camera, 400-point instance: Y and the
    scaled camera rows Js_c of lm_step_schur, through its own point plan."""
    from ceres_tpu_torch.parallel import sharded_ba as sb

    b = small_bal()
    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    ci, pi, obs = sb.observations_by_point(b.camera_index, b.point_index,
                                           b.observations, dt, card)
    plan = sb.build_point_plan(ci, pi, b.num_points, b.num_cameras, card)
    st = sb.state_from_arrays(b.cameras, b.points, 1e4, dt, card)
    seen = {}

    def spy(Y, cam_ids, C, tp, tc, Jc):
        seen["args"] = (Y.contiguous(), cam_ids, plan.rows.pt_start, C, tp, tc,
                        Jc.contiguous(), 2, plan.rows)
        return kn.segment_spread_sum(*seen["args"])

    env = sb._env(st.cams, ci, pi, b.num_points, None, plan)
    env = env._replace(spread_p=spy)
    r, J = sb._evaluate_flat(st.cams, st.pts, env.ci, obs, None, env.expand_p)
    sb._schur_core(J, r, st.radius, env, b.num_cameras, b.num_points)
    return seen["args"]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_spread_ftf_matches_plain_on_card(card, dtype):
    """Kernel 8J (segment_spread_sum with Jc) against its plain version on
    the same card inputs, A and F'F relative to their largest entry: 1e-11
    in float64, 1e-4 in float32."""
    args = _specialized_inputs(card, dtype)
    kn.reset_counts()
    out = kn.segment_spread_sum(*args)
    torch.cuda.synchronize()
    ref = kn.segment_spread_ftf_plain(*args)
    assert kn.segment_spread_ftf.launches == 1
    assert kn.segment_spread_ftf.plain_calls == 0
    for o, r in zip(out, ref):
        err = (o.double() - r.double()).abs().max().item()
        assert err <= REL_LIMIT[o.dtype] * r.double().abs().max().item()


def test_specialized_pipeline_on_card_matches_cpu(card):
    """lm_step_schur_k (k = 10) with the point plan on the card (kernels 6,
    7 and 8J, each launched every iteration) and on the CPU (their plain
    versions), float64: cameras, points and cost to 1e-9 relative."""
    from ceres_tpu_torch.parallel import sharded_ba as sb

    b = small_bal()
    out = {}
    for dev in (card, torch.device("cpu")):
        ci, pi, obs = sb.observations_by_point(b.camera_index, b.point_index,
                                               b.observations, torch.float64, dev)
        plan = sb.build_point_plan(ci, pi, b.num_points, b.num_cameras, dev)
        st = sb.state_from_arrays(b.cameras, b.points, 1e4, torch.float64, dev)
        kn.reset_counts()
        out[dev.type] = sb.lm_step_schur_k(st.cams, st.pts, ci, pi, obs, st.radius,
                                           k=10, plan=plan)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            for k in (kn.segment_block_sum, kn.segment_block_expand,
                      kn.segment_spread_ftf):
                assert k.launches >= 10 and k.plain_calls == 0, k.__name__
            assert kn.segment_spread_ftf.launches == 10
            assert kn.segment_spread_sum.launches == 0
    for name in ("cams", "pts", "cost"):
        a = getattr(out["cpu"], name)
        c = getattr(out["cuda"], name).cpu()
        assert (c - a).abs().max().item() <= 1e-9 * a.abs().max().item(), name


_VARIANT_LOSSES = {
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


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("model", ["angle_axis", "quat"])
@pytest.mark.parametrize("loss_name", list(_VARIANT_LOSSES))
def test_eval_fused_variant_matches_plain_on_card(card, model, loss_name, dtype):
    """eval_fused with each loss, in both camera models, against its plain
    version on the card: 1e-11 in float64, 1e-4 in float32, relative to
    each output's largest entry; the launch counts on its variant."""
    build = (tbal.build_problem_batched_quat if model == "quat"
             else tbal.build_problem_batched)
    prog = CompiledProgram(build(small_bal(), _VARIANT_LOSSES[loss_name]())[0], dtype,
                           device=card)
    ops = DenseSchurStepOps(
        prog, ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR), [1])
    q, x, dt = ops._jt_qual, prog.initial_state(), prog.compute_dtype
    args = (prog.family_table(x, q.fam_f).to(dt).contiguous(),
            prog.family_table(x, q.fam_e).to(dt).contiguous(),
            prog.kinds[0].data, ops.flat.plan, q.rows_fn, q.loss)
    kn.reset_counts()
    out = kn.eval_fused(*args)
    torch.cuda.synchronize()
    ref = kn.eval_fused_plain(*args)
    variant = ("eval_fused_quat" if model == "quat" else
               "eval_fused_loss" if q.loss.ops else "eval_fused")
    assert {k.__name__: k.launches for k in kn.KERNELS if k.launches} == {variant: 1}
    for o, r in zip(out, ref):
        err = (o.double() - r.double()).abs().max().item()
        assert err <= REL_LIMIT[dt] * r.double().abs().max().item()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("model,loss", [("angle_axis", None), ("quat", "huber")])
def test_eval_fused_one_launch_on_card(card, monkeypatch, model, loss, dtype):
    """eval_fused's cost in the launch that forms the rows: the cost equals
    the fixed-order sum of its block partials bit for bit, the count of
    finished blocks is 0 after each call, so a repeat gives the same bits."""
    b = tbal.perturb(tbal.synthetic_bal(num_cameras=6, num_points=6000, visibility=0.5,
                                        seed=5), 0.01, 0.05, 0.05, seed=1)
    build = (tbal.build_problem_batched_quat if model == "quat"
             else tbal.build_problem_batched)
    prog = CompiledProgram(build(b, None if loss is None else ctt.HuberLoss(1.0))[0],
                           dtype, device=card)
    ops = DenseSchurStepOps(
        prog, ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR), [1])
    q, x, dt = ops._jt_qual, prog.initial_state(), prog.compute_dtype
    args = (prog.family_table(x, q.fam_f).to(dt).contiguous(),
            prog.family_table(x, q.fam_e).to(dt).contiguous(),
            prog.kinds[0].data, ops.flat.plan, q.rows_fn, q.loss)
    seen = []
    workspace = kn._eval_workspace
    monkeypatch.setattr(kn, "_eval_workspace",
                        lambda n, dev: seen.append(workspace(n, dev)) or seen[-1])
    nt = kn.EVAL_THREADS[dt]
    outs = []
    for _ in range(3):
        outs.append(kn.eval_fused(*args))
        torch.cuda.synchronize()
        partial, done = (t.cpu() for t in seen[-1])
        assert int(done) == 0 and partial.shape[0] == -(-ops.flat.plan.B // nt)
        acc = [0.0] * kn.EVAL_SUM_THREADS
        for i, v in enumerate(partial.tolist()):
            acc[i % kn.EVAL_SUM_THREADS] += v
        s = kn.EVAL_SUM_THREADS // 2
        while s:
            for t in range(s):
                acc[t] += acc[t + s]
            s //= 2
        assert float(outs[-1][0]) == acc[0]
    for out in outs[1:]:
        assert all(torch.equal(a, c) for a, c in zip(out, outs[0]))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("te,C,tf", [(3, 16, 9), (3, 5, 3), (3, 400, 9)])
def test_spread_slab_is_the_first_designs_sums_on_card(card, te, C, tf, dtype):
    """segment_spread_sum's slab pass on the card, bit for bit the first
    design's sums (each entry 0 plus its point's rows of its camera in row
    order, in the dtype), at a width of whole 16-byte groups, one of none,
    and one wider than a block's stretch of shared memory; camera ids
    outside [0, C) add nothing."""
    dt = {"float64": torch.float64, "float32": torch.float32}[dtype]
    rng = np.random.default_rng(C)
    counts = rng.integers(0, 7, 40 if C > 100 else 600)
    counts[3] = 700
    pt_start = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    B = int(pt_start[-1])
    cam = rng.integers(-1, C + 1, B).astype(np.int32)
    Y = rng.standard_normal((B, te * tf)).astype(str(dt)[6:])
    ref = np.zeros((len(counts), te, C, tf), Y.dtype)
    for p in range(len(counts)):
        for r in range(pt_start[p], pt_start[p + 1]):
            if 0 <= cam[r] < C:
                ref[p, :, cam[r], :] += Y[r].reshape(te, tf)
    kn.reset_counts()
    A = kn.segment_spread_sum(torch.as_tensor(Y, device=card),
                              torch.as_tensor(cam, device=card),
                              torch.as_tensor(pt_start, device=card), C, te, tf)
    assert kn.segment_spread_sum.launches == 1
    assert torch.equal(A.cpu(), torch.as_tensor(ref.reshape(len(counts), -1)))


def test_robust_quaternion_solve_on_card_matches_cpu(card):
    """Quaternion cameras with CauchyLoss(0.5), DENSE_SCHUR, on the card
    and on the CPU: the same rows, each cost to 1e-9 relative, and the
    quaternion variant launched once per evaluation."""
    b = tbal.perturb(tbal.synthetic_bal(num_cameras=6, num_points=80, visibility=0.4,
                                        seed=0), 0.02, 0.1, 0.1, seed=1)
    arrays = (b.cameras, b.points, b.camera_index, b.point_index, b.observations)
    opts = ctt.Options(fused_loop="ALWAYS", linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR)

    def problem():
        return tbal.build_problem_batched_quat(tbal.from_arrays(*arrays),
                                               ctt.CauchyLoss(0.5))[0]

    ref = ctt.solve(opts, problem(), device="cpu")
    kn.reset_counts()
    out = ctt.solve(opts, problem())
    assert kn.eval_fused_quat.launches == len(out.iterations)
    assert kn.eval_fused_quat.plain_calls == 0
    assert len(out.iterations) == len(ref.iterations)
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9)


def _rows_match_within_rounding(out, ref, twin):
    """The same rows and CG counts; each row's cost within 1e-9 relative, or
    4x the CPU's own one-ulp sensitivity (the solve from cameras one ulp
    away: `twin`) where that is larger, as chip_smoke.py's card_against_cpu."""
    assert len(out.iterations) == len(ref.iterations)
    assert ([r.linear_solver_iterations for r in out.iterations]
            == [r.linear_solver_iterations for r in ref.iterations])
    for a, c, u in zip(ref.iterations, out.iterations, twin.iterations):
        sens = abs(u.cost - a.cost) / abs(a.cost)
        assert c.cost == pytest.approx(a.cost, rel=max(1e-9, 4 * sens))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cgnr_kernel_matvec_matches_plain_on_card(card, dtype):
    """CGNR's (J_s'J_s) x through normal_matvec on the card against the same
    product through its plain version on the CPU, at the card's lanes and
    the same scales and x: 1e-11 relative in float64, 1e-4 in float32; one
    launch a product."""
    from ceres_tpu_torch.solvers.fused_lm import CgnrStepOps

    opts = ctt.Options(linear_solver_type=ctt.LinearSolverType.CGNR)
    ops = {}
    for dev in (card, torch.device("cpu")):
        prog = CompiledProgram(tbal.build_problem_batched(small_bal())[0], dtype,
                               device=dev)
        ops[dev.type] = CgnrStepOps(prog, opts)
    _, vrep = ops["cuda"].evaluate(prog.initial_state().to(card))
    rng = np.random.default_rng(4)
    s = torch.as_tensor(rng.uniform(0.5, 1.5, prog.tangent_size)).to(prog.compute_dtype)
    x = torch.as_tensor(rng.standard_normal(prog.tangent_size)).to(prog.compute_dtype)
    kn.reset_counts()
    out = ops["cuda"].flat.make_kernel_matvec(vrep.jt, s.to(card))(x.to(card)).cpu()
    assert kn.normal_matvec.launches == 1 and kn.normal_matvec.plain_calls == 0
    ref = ops["cpu"].flat.make_kernel_matvec(vrep.jt.cpu(), s)(x)
    assert (out - ref).abs().max() <= REL_LIMIT[ref.dtype] * ref.abs().max()


def _bal_problem(b):
    return tbal.build_problem_batched(tbal.from_arrays(
        b.cameras, b.points, b.camera_index, b.point_index, b.observations))[0]


@pytest.mark.parametrize("prec,iterations", [("JACOBI", 8), ("IDENTITY", 3)])
def test_cgnr_solve_on_card_matches_cpu(card, prec, iterations):
    """CGNR on the card (normal_matvec, the segment sums, the gather) and on
    the CPU, float64: the same rows and CG counts, each row's cost within
    1e-9 or 4x the CPU's one-ulp sensitivity. IDENTITY is cut to 3 LM
    iterations: its fourth takes ~50 unpreconditioned CG iterations, whose
    count follows rounding (the card took 49 where the CPU took 48)."""
    b = small_bal()
    ulp = tbal.from_arrays(np.nextafter(b.cameras, np.inf), b.points, b.camera_index,
                           b.point_index, b.observations)
    opts = ctt.Options(fused_loop="ALWAYS", linear_solver_type=ctt.LinearSolverType.CGNR,
                       preconditioner_type=ctt.PreconditionerType[prec],
                       max_num_iterations=iterations)
    ref = ctt.solve(opts, _bal_problem(b), device="cpu")
    twin = ctt.solve(opts, _bal_problem(ulp), device="cpu")
    kn.reset_counts()
    out = ctt.solve(opts, _bal_problem(b))
    n_it = len(out.iterations) - 1
    path = ("normal_matvec", "segment_block_sum", "segment_block_expand",
            "unsorted_segment_sum")
    for k in kn.KERNELS:
        assert k.plain_calls == 0, k.__name__
        assert (k.launches >= n_it) if k.__name__ in path else k.launches == 0, k.__name__
    assert kn.normal_matvec.launches >= sum(r.linear_solver_iterations
                                            for r in out.iterations)
    _rows_match_within_rounding(out, ref, twin)


@pytest.mark.parametrize("dogleg", ["TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG"])
def test_dogleg_dense_schur_on_card_matches_cpu(card, dogleg):
    """DENSE_SCHUR with dogleg from radius 1 (the dogleg path binds) on the
    card, through the flat Schur path's kernels, and on the CPU: the same
    rows, each cost and radius to 1e-9 relative."""
    b = small_bal()
    opts = ctt.Options(fused_loop="ALWAYS", linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                       trust_region_strategy_type=ctt.TrustRegionStrategyType.DOGLEG,
                       dogleg_type=ctt.DoglegType[dogleg], initial_trust_region_radius=1.0)
    ref = ctt.solve(opts, _bal_problem(b), device="cpu")
    kn.reset_counts()
    out = ctt.solve(opts, _bal_problem(b))
    assert kn.segment_spread_sum.launches >= len(out.iterations) - 1
    assert kn.eval_fused.launches == 0 and kn.schur_assembly.launches == 0
    assert len(out.iterations) == len(ref.iterations)
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9)
        assert c.trust_region_radius == pytest.approx(a.trust_region_radius, rel=1e-9)


@pytest.mark.parametrize("lst", ["DENSE_QR", "DENSE_NORMAL_CHOLESKY"])
@pytest.mark.parametrize("number", [1, 8, 19])
def test_mgh_dense_solve_on_card_matches_cpu(card, lst, number):
    """MGH #1, #8 and #19 with a dense solver on the card and on the CPU:
    both reach the optimum, 2 * final cost within 1e-8 relative (or both
    under 1e-20 for Rosenbrock's zero); no kernel runs."""
    from ceres_tpu_torch.models import mgh

    over = {"linear_solver_type": ctt.LinearSolverType[lst]}
    p = mgh.PROBLEMS[number - 1]
    ok_ref, ref, _ = mgh.solve_problem(p, options_overrides=over, device="cpu")
    kn.reset_counts()
    ok, out, s = mgh.solve_problem(p, options_overrides=over)
    assert ok and ok_ref and s.device_kind != "cpu"
    assert all(k.launches == 0 and k.plain_calls == 0 for k in kn.KERNELS)
    if p.unconstrained_optimal_cost == 0.0:
        assert out < 1e-20 and ref < 1e-20
    else:
        assert out == pytest.approx(ref, rel=1e-8)


@pytest.mark.parametrize("constant", [(0,), (2, 5)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernels_with_a_constant_camera_on_card(card, dtype, constant):
    """Rows 1, 2, 3, 3b, 4, 4b at a plan with constant cameras (the
    sentinel), rows 6, 7 and 9 at the sentinel key
    (chip_smoke.sentinel_cases), kernel against plain version on the card:
    1e-11 [1e-4] of each output's largest entry, by the working dtype
    (eval_fused's cost is a float64 sum in both), the gather exactly."""
    import chip_smoke

    limit_dt = REL_LIMIT[getattr(torch, dtype)]
    for name, args in chip_smoke.sentinel_cases(dtype, card, constant).items():
        kn.reset_counts()
        out = chip_smoke.as_tuple(getattr(kn, name)(*args))
        ref = chip_smoke.as_tuple(getattr(kn, name + "_plain")(*args))
        assert getattr(kn, name).launches == 1, name
        for o, r in zip(out, ref):
            if r is None:
                continue
            err = (o.double() - r.double()).abs().max().item()
            limit = 0.0 if name == "segment_block_expand" else limit_dt
            assert err <= limit * r.double().abs().max().item(), name


@pytest.mark.parametrize("lst", ["DENSE_SCHUR", "ITERATIVE_SCHUR"])
def test_gauge_fixed_solve_on_card_matches_cpu(card, lst):
    """BA built one block at a time with camera 0 constant, on the card's
    jt kernels and on the CPU: the same rows and CG counts, each cost to
    1e-9 relative; the constant camera unchanged."""
    import chip_smoke

    b = small_bal()
    opts = ctt.Options(fused_loop="ALWAYS",
                       linear_solver_type=ctt.LinearSolverType[lst], max_num_iterations=8)
    ref = ctt.solve(opts, chip_smoke.gauge_fixed_problem(tbal, b)[0], device="cpu")
    p, cams, _ = chip_smoke.gauge_fixed_problem(tbal, b)
    before = cams[0].copy()
    kn.reset_counts()
    out = ctt.solve(opts, p)
    assert kn.eval_fused.launches == len(out.iterations)
    assert ([r.linear_solver_iterations for r in out.iterations]
            == [r.linear_solver_iterations for r in ref.iterations])
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9)
    np.testing.assert_array_equal(cams[0], before)


def test_bounded_solve_on_card_matches_cpu(card):
    """BA with a box on the points (5th to 95th percentile of the start):
    the same rows on the card and the CPU, each cost to 1e-9 relative, and
    every point inside the box."""
    b = small_bal()
    lo, hi = (np.percentile(b.points, q, axis=0) for q in (5.0, 95.0))

    def problem():
        p, _, pts = tbal.build_problem_batched(tbal.from_arrays(
            b.cameras, b.points, b.camera_index, b.point_index, b.observations))
        p.set_parameter_block_array_bounds(p.parameter_block_arrays()[1], lower=lo,
                                           upper=hi)
        return p, pts

    opts = ctt.Options(fused_loop="ALWAYS", linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                       max_num_iterations=10)
    ref = ctt.solve(opts, problem()[0], device="cpu")
    p, pts = problem()
    out = ctt.solve(opts, p)
    assert len(out.iterations) == len(ref.iterations)
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9)
    assert np.all(pts >= lo) and np.all(pts <= hi)


@pytest.mark.parametrize("number", [7, 14])
def test_constrained_mgh_on_card_matches_cpu(card, number):
    """Constrained MGH #7 and #14 with DENSE_NORMAL_CHOLESKY and mixed
    solves on the card and the CPU: both solved, 2 * final cost within
    1e-8 relative; no kernel runs."""
    from ceres_tpu_torch.models import mgh

    over = {"linear_solver_type": ctt.LinearSolverType.DENSE_NORMAL_CHOLESKY,
            "use_mixed_precision_solves": True}
    p = mgh.PROBLEMS[number - 1]
    ok_ref, ref, _ = mgh.solve_problem(p, True, options_overrides=over, device="cpu")
    kn.reset_counts()
    ok, out, s = mgh.solve_problem(p, True, options_overrides=over)
    assert ok and ok_ref and s.is_constrained
    assert all(k.launches == 0 and k.plain_calls == 0 for k in kn.KERNELS)
    assert out == pytest.approx(ref, rel=1e-8)


def test_problem_evaluation_on_card_matches_cpu(card):
    """Problem.evaluate (dense and CRS) and evaluate_residual_block with
    no device argument run on the card: autodiff with a loss, central
    differences and a normal prior, each output within 1e-12 of the
    CPU's."""
    from ceres_tpu_torch.cost_function import (
        AutoDiffCostFunction,
        NormalPrior,
        NumericDiffCostFunction,
    )

    def f(x, y):
        return torch.stack([x[0] * y[1] - 1.0, torch.sin(x[1]) + y[0], x[0] + x[1] * y[1]])

    p = ctt.Problem()
    x, y = np.asarray([0.5, -1.5]), np.asarray([2.0, 0.25])
    blocks = [p.add_residual_block(AutoDiffCostFunction(f, 3, [2, 2]), ctt.CauchyLoss(0.5),
                                   [x, y]),
              p.add_residual_block(NumericDiffCostFunction(f, 3, [2, 2]), None, [y, x]),
              p.add_residual_block(NormalPrior(np.eye(2) * 3.0, np.ones(2)), None, [y])]
    for rb in blocks:
        on_card, on_cpu = p.evaluate_residual_block(rb), p.evaluate_residual_block(
            rb, device="cpu")
        assert on_card[0] == pytest.approx(on_cpu[0], rel=1e-12)
        np.testing.assert_allclose(on_card[1], on_cpu[1], rtol=1e-12, atol=1e-14)
        for a, c in zip(on_card[2], on_cpu[2]):
            np.testing.assert_allclose(a, c, rtol=1e-12, atol=1e-14)
    card_out = p.evaluate(residuals=True, gradient=True, jacobian=True)
    cpu_out = p.evaluate(residuals=True, gradient=True, jacobian=True, device="cpu")
    assert card_out[0] == pytest.approx(cpu_out[0], rel=1e-12)
    for a, c in zip(card_out[1:], cpu_out[1:]):
        np.testing.assert_allclose(a, c, rtol=1e-12, atol=1e-14)
    crs_card = p.evaluate(jacobian=True, jacobian_format="crs")[1]
    np.testing.assert_allclose(crs_card.to_dense(), cpu_out[3], rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("lst", ["DENSE_QR", "DENSE_SCHUR", "ITERATIVE_SCHUR", "CGNR"])
def test_host_loop_on_card_matches_cpu(card, lst):
    """The host loop (AUTO takes it for this problem, under 8,192
    residuals) on the card and the CPU: the same rows and CG counts, each
    cost to 1e-9 relative; the block steps launch rows 6, 7 and 9 (CGNR
    also row 4) and run no plain version, the dense one no kernel."""
    b = small_bal()
    opts = ctt.Options(linear_solver_type=ctt.LinearSolverType[lst], max_num_iterations=8)

    def problem():
        return tbal.build_problem_batched(tbal.from_arrays(
            b.cameras, b.points, b.camera_index, b.point_index, b.observations))[0]

    ref = ctt.solve(opts, problem(), device="cpu")
    kn.reset_counts()
    out = ctt.solve(opts, problem())
    assert out.num_host_syncs > 2 * (len(out.iterations) - 1)  # the host loop's
    assert ([r.linear_solver_iterations for r in out.iterations]
            == [r.linear_solver_iterations for r in ref.iterations])
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9)
    assert all(k.plain_calls == 0 for k in kn.KERNELS)
    block = ("segment_block_sum", "segment_block_expand", "unsorted_segment_sum")
    for k in kn.KERNELS:
        want = lst != "DENSE_QR" and (k.__name__ in block
                                      or (lst == "CGNR" and k.__name__ == "normal_matvec"))
        assert (k.launches > 0) == want, (k.__name__, k.launches)


def test_host_loop_callbacks_on_card(card):
    """An IterationCallback ending the host loop on the card at row 3 with
    update_state_every_iteration: USER_SUCCESS in 4 rows, the points the
    iterate at each callback (their cost on the CPU is the row's, 1e-9)."""
    b = small_bal()
    p, cams, pts = tbal.build_problem_batched(tbal.from_arrays(
        b.cameras, b.points, b.camera_index, b.point_index, b.observations))
    seen = []

    def cb(it):
        seen.append((it.cost, it.step_is_successful, cams.copy(), pts.copy()))
        return (ctt.CallbackReturnType.SOLVER_TERMINATE_SUCCESSFULLY if it.iteration == 3
                else ctt.CallbackReturnType.SOLVER_CONTINUE)

    s = ctt.solve(ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                              callbacks=[cb], update_state_every_iteration=True), p)
    assert s.termination_type == ctt.TerminationType.USER_SUCCESS and len(s.iterations) == 4
    assert s.message == "User callback returned SOLVER_TERMINATE_SUCCESSFULLY."
    for cost, ok, cams_i, pts_i in seen:
        if not ok:
            continue
        q = tbal.build_problem_batched(tbal.from_arrays(
            cams_i, pts_i, b.camera_index, b.point_index, b.observations))[0]
        prog = CompiledProgram(q, device="cpu")
        assert float(prog.evaluate_cost(prog.initial_state())) == pytest.approx(cost, rel=1e-9)


@pytest.mark.parametrize("kw", [
    dict(linear_solver_type="SPARSE_SCHUR"),
    dict(linear_solver_type="SPARSE_SCHUR", evaluation_dtype="float32"),
    dict(linear_solver_type="SPARSE_NORMAL_CHOLESKY"),
    dict(linear_solver_type="SPARSE_NORMAL_CHOLESKY", dynamic_sparsity=True),
    dict(linear_solver_type="SPARSE_NORMAL_CHOLESKY", use_mixed_precision_solves=True,
         max_num_refinement_iterations=3),
], ids=["sparse_schur", "sparse_schur_f32", "snc", "snc_dynamic", "snc_mixed"])
def test_sparse_solvers_on_card_match_cpu(card, kw):
    """The sparse direct solvers in the host loop on the card and the CPU:
    the same rows, each cost to 1e-9 relative (float32: 1e-5); the values
    of J'J or S summed by rows 6 and 7 (with 9 for the camera sums), no
    plain version; a float64 repeat bit for bit."""
    kw = dict(kw, linear_solver_type=ctt.LinearSolverType[kw["linear_solver_type"]])
    b = small_bal()
    opts = ctt.Options(max_num_iterations=8, **kw)

    def problem():
        return tbal.build_problem_batched(tbal.from_arrays(
            b.cameras, b.points, b.camera_index, b.point_index, b.observations))[0]

    ref = ctt.solve(opts, problem(), device="cpu")
    kn.reset_counts()
    out = ctt.solve(opts, problem())
    assert len(out.iterations) == len(ref.iterations)
    rel = 1e-5 if kw.get("evaluation_dtype") == "float32" else 1e-9
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=rel, abs=1e-30)
    assert all(k.plain_calls == 0 for k in kn.KERNELS)
    assert kn.segment_block_sum.launches > 0 and kn.segment_block_expand.launches > 0
    if "evaluation_dtype" not in kw:
        again = ctt.solve(opts, problem())
        assert [r.cost for r in again.iterations] == [r.cost for r in out.iterations]


def test_cgnr_subset_and_pose_graph_on_card_match_cpu(card):
    """CGNR + SUBSET (a per-block BAL problem, one observation of 8 points
    left out of the subset) and a 3D pose graph with the default options
    on the card and the CPU: the same rows and CG counts, each cost to 1e-9."""
    from ceres_tpu_torch.models import pose_graph as pg

    b = tbal.perturb(tbal.synthetic_bal(num_cameras=8, num_points=150, visibility=0.8,
                                        seed=0), 0.01, 0.05, 0.05, seed=1)
    counts = np.bincount(b.point_index, minlength=b.num_points)

    def bal_problem():
        p = tbal.build_problem(tbal.from_arrays(
            b.cameras, b.points, b.camera_index, b.point_index, b.observations))[0]
        dropped, keep = set(), []
        for rb, q in zip(p.residual_blocks(), b.point_index):
            if counts[q] >= 6 and q not in dropped and len(dropped) < 8:
                dropped.add(q)
                continue
            keep.append(rb.rb_id)
        return p, ctt.Options(linear_solver_type=ctt.LinearSolverType.CGNR,
                              preconditioner_type=ctt.PreconditionerType.SUBSET,
                              residual_blocks_for_subset_preconditioner=keep, eta=1e-2)

    poses, cons, _ = pg.synthetic_3d(num_poses=40, loop_closures=8, noise=0.01, seed=1)

    def pose_problem():
        import copy
        return pg.build_problem_3d(copy.deepcopy(poses), cons)[0], ctt.Options()

    for make in (bal_problem, pose_problem):
        p, opts = make()
        ref = ctt.solve(opts, p, device="cpu")
        p, opts = make()
        out = ctt.solve(opts, p)
        assert len(out.iterations) == len(ref.iterations)
        for a, c in zip(ref.iterations, out.iterations):
            assert c.cost == pytest.approx(a.cost, rel=1e-9, abs=1e-30)
            assert c.linear_solver_iterations == a.linear_solver_iterations


def _precond_setup(dev, tridiagonal):
    """The 6-camera problem's flat ops at its initial state on `dev`, four
    clusters (camera i in cluster i % 4; a chain of them for
    CLUSTER_TRIDIAGONAL), their block assembler, the Jacobian blocks and
    a damping."""
    from ceres_tpu_torch.ops import bsr
    from ceres_tpu_torch.solvers.linear import preconditioners as tpc
    from ceres_tpu_torch.utils import ordering

    prog = CompiledProgram(tbal.build_problem_batched(small_bal())[0], device=dev)
    pm = pt.build_partition(bsr.build_meta(prog), ordering.eligible_e_sets(prog))
    flat = fo.FlatSchurOps(pm, prog)
    vflat = flat.flatten(prog._eval_core(prog.initial_state())["block_jacs"])
    num_f = sum(nv for (_, nv, _, _) in pm.f_fams)
    cs = tpc.ClusterStructure(pm, np.arange(num_f) % 4,
                              [(0, 1), (1, 2), (2, 3)] if tridiagonal else None, dev)
    D = torch.as_tensor(np.random.default_rng(3).uniform(0.5, 1.5, pm.base.tangent_size),
                        device=dev)
    return pm, flat, vflat, cs, tpc.ClusterBlockAssembler(pm, cs, flat), D


@pytest.mark.parametrize("tridiagonal", [False, True])
def test_cluster_blocks_on_card_match_cpu(card, tridiagonal):
    """The cluster preconditioner's blocks formed on the card (rows 6 and
    7, float64) against the CPU's plain forms, 1e-12 of the largest entry;
    a repeat on the card bit for bit; the apply against the CPU's, 1e-10."""
    from ceres_tpu_torch.solvers.linear import preconditioners as tpc

    outs = {}
    for dev in (torch.device("cpu"), card):
        pm, flat, vflat, cs, asm, D = _precond_setup(dev, tridiagonal)
        D_e, D_f = pt.extract_e(pm, D), pt.extract_f(pm, D)
        kn.reset_counts()
        blocks = asm(vflat, D_e, D_f)
        if dev.type == "cuda":
            assert all(k.plain_calls == 0 for k in kn.KERNELS)
            assert kn.segment_block_sum.launches > 0 and kn.segment_block_expand.launches > 0
            again = asm(vflat, D_e, D_f)
            for a, b in zip(*((blocks, again) if tridiagonal else ((blocks,), (again,)))):
                assert torch.equal(a, b)
        make = (tpc.make_cluster_tridiagonal_preconditioner if tridiagonal
                else tpc.make_cluster_preconditioner)
        v = torch.as_tensor(np.random.default_rng(5).standard_normal(pm.f_size), device=dev)
        outs[dev.type] = ([x.cpu() for x in (blocks if tridiagonal else (blocks,))],
                          make(cs, lambda: blocks)(v).cpu())
    for a, b in zip(outs["cpu"][0], outs["cuda"][0]):
        assert (a - b).abs().max() <= 1e-12 * max(a.abs().max(), 1.0)
    a, b = outs["cpu"][1], outs["cuda"][1]
    assert (a - b).abs().max() <= 1e-10 * max(a.abs().max(), 1.0)


def test_csr_matvec_on_card_matches_cpu(card):
    """The explicit S's CSR values and product (rows 7 and 6) on the card
    against the CPU's plain forms, 1e-12 of the largest entry; a repeat on
    the card bit for bit."""
    from ceres_tpu_torch.solvers.linear import implicit_schur as tis
    from ceres_tpu_torch.solvers.linear import sparse_schur as tss

    outs = {}
    for dev in (torch.device("cpu"), card):
        pm, flat, vflat, _, _, D = _precond_setup(dev, False)
        prog_r = torch.as_tensor(np.random.default_rng(7).standard_normal(
            sum(k.B * k.r for k in pm.base.kinds)), device=dev)
        sys = tis.build_schur_system(pm, vflat, prog_r, pt.extract_e(pm, D), flat)
        sss = tss.SparseSchurSolver(pm, flat)
        svals = sss.values(vflat, sys.minv, pt.extract_f(pm, D))
        mv = sss.csr_matvec_fn()
        z = torch.as_tensor(np.random.default_rng(8).standard_normal(pm.f_size), device=dev)
        kn.reset_counts()
        out = mv(svals, z)
        if dev.type == "cuda":
            assert all(k.plain_calls == 0 for k in kn.KERNELS)
            assert kn.segment_block_sum.launches == kn.segment_block_expand.launches == 1
            assert torch.equal(out, mv(svals, z))
        outs[dev.type] = (svals.cpu(), out.cpu())
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert (a - b).abs().max() <= 1e-12 * max(a.abs().max(), 1.0)


@pytest.mark.parametrize("kw", [
    dict(preconditioner_type="SCHUR_POWER_SERIES_EXPANSION"),
    dict(use_spse_initialization=True),
    dict(preconditioner_type="CLUSTER_JACOBI"),
    dict(preconditioner_type="CLUSTER_TRIDIAGONAL"),
    dict(use_explicit_schur_complement=True),
], ids=["spse", "spse_init", "cluster_jacobi", "cluster_tridiagonal", "explicit"])
@pytest.mark.parametrize("loop", ["NEVER", "ALWAYS"])
def test_preconditioners_on_card_match_cpu(card, kw, loop):
    """ITERATIVE_SCHUR with each new option on the card and the CPU, in
    both loops: the same rows, each cost to 1e-9 relative, no plain
    version on the card."""
    if "preconditioner_type" in kw:
        kw = dict(kw, preconditioner_type=ctt.PreconditionerType[kw["preconditioner_type"]])
    b = small_bal()
    opts = ctt.Options(linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR,
                       max_num_iterations=8, fused_loop=loop, **kw)

    def problem():
        return tbal.build_problem_batched(tbal.from_arrays(
            b.cameras.copy(), b.points.copy(), b.camera_index, b.point_index,
            b.observations))[0]

    ref = ctt.solve(opts, problem(), device="cpu")
    kn.reset_counts()
    out = ctt.solve(opts, problem())
    assert len(out.iterations) == len(ref.iterations)
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9, abs=1e-30)
    assert all(k.plain_calls == 0 for k in kn.KERNELS)
    assert kn.segment_block_sum.launches > 0 and kn.segment_block_expand.launches > 0


def _small_problem(b):
    return tbal.build_problem_batched(tbal.from_arrays(
        b.cameras.copy(), b.points.copy(), b.camera_index, b.point_index, b.observations))


@pytest.mark.parametrize("kw", [
    dict(fused_loop="ALWAYS"), dict(fused_loop="NEVER"),
    dict(fused_loop="ALWAYS", line_search_type="ARMIJO",
         line_search_direction_type="NONLINEAR_CONJUGATE_GRADIENT"),
], ids=["lbfgs_fused", "lbfgs_host", "ncg_armijo_fused"])
def test_line_search_on_card_matches_cpu(card, kw):
    """LINE_SEARCH on the card and the CPU, float64, 20 iterations: the
    same rows, each cost to 1e-9 relative, the same probe count; no kernel
    and no plain version launched (the line search evaluates plainly); at
    most one host sync per probe and per iteration and one before the
    first."""
    kw = dict(kw)
    if "line_search_type" in kw:
        kw["line_search_type"] = ctt.LineSearchType[kw["line_search_type"]]
        kw["line_search_direction_type"] = ctt.LineSearchDirectionType[
            kw["line_search_direction_type"]]
    b = small_bal()
    opts = ctt.Options(minimizer_type=ctt.MinimizerType.LINE_SEARCH, max_num_iterations=20,
                       **kw)
    ref = ctt.solve(opts, _small_problem(b)[0], device="cpu")
    kn.reset_counts()
    out = ctt.solve(opts, _small_problem(b)[0])
    assert len(out.iterations) == len(ref.iterations) > 5
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9, abs=1e-30)
    assert out.num_line_search_steps == ref.num_line_search_steps
    assert all(k.launches == 0 and k.plain_calls == 0 for k in kn.KERNELS)
    assert out.num_host_syncs <= out.num_line_search_steps + len(out.iterations)


@pytest.mark.parametrize("loop", ["ALWAYS", "NEVER"])
def test_inner_iterations_on_card_match_cpu(card, loop):
    """DENSE_SCHUR with inner iterations on the card and the CPU, float64,
    10 iterations: the same rows, each cost to 1e-9 relative, the same
    inner steps; the fused loop launches eval_fused once per row and once
    more per inner sweep, the rows' kernels and no plain version."""
    b = small_bal()
    opts = ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                       use_inner_iterations=True, fused_loop=loop, max_num_iterations=10)
    ref = ctt.solve(opts, _small_problem(b)[0], device="cpu")
    kn.reset_counts()
    out = ctt.solve(opts, _small_problem(b)[0])
    assert len(out.iterations) == len(ref.iterations)
    for a, c in zip(ref.iterations, out.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9, abs=1e-30)
    assert out.num_inner_iteration_steps == ref.num_inner_iteration_steps >= 1
    assert out.inner_iterations_used
    assert all(k.plain_calls == 0 for k in kn.KERNELS)
    if loop == "ALWAYS":
        n_rows, n_it = len(out.iterations), len(out.iterations) - 1
        assert n_rows + out.num_inner_iteration_steps <= kn.eval_fused.launches <= n_rows + n_it
        assert kn.post_eval_fused.launches >= n_it and kn.schur_assembly.launches >= n_it


@pytest.mark.parametrize("kw", [
    dict(linear_solver_type="DENSE_SCHUR", fused_loop="ALWAYS"),
    dict(linear_solver_type="DENSE_SCHUR", fused_loop="ALWAYS", use_inner_iterations=True),
    dict(minimizer_type="LINE_SEARCH", fused_loop="ALWAYS"),
], ids=["dense_fused", "dense_fused_inner", "line_search_fused"])
def test_repeated_solve_on_card_reuses_program(card, kw):
    """Solve on the card, put the values back, solve again: the same
    program and fused minimizer objects, the rows bit for bit the first
    solve's and a fresh Problem's."""
    kw = dict(kw)
    if "linear_solver_type" in kw:
        kw["linear_solver_type"] = ctt.LinearSolverType[kw["linear_solver_type"]]
    if "minimizer_type" in kw:
        kw["minimizer_type"] = ctt.MinimizerType[kw["minimizer_type"]]
    opts = ctt.Options(max_num_iterations=10, **kw)
    b = small_bal()
    problem, cams, pts = _small_problem(b)
    c0, p0 = cams.copy(), pts.copy()
    s1 = ctt.solve(opts, problem)
    (prog,) = problem._compiled_cache.values()
    assert prog.device.type == "cuda"
    fused = dict(prog._minimizer_cache)
    assert fused
    cams[...], pts[...] = c0, p0
    s2 = ctt.solve(opts, problem)
    assert next(iter(problem._compiled_cache.values())) is prog
    assert prog._minimizer_cache == fused
    s3 = ctt.solve(opts, _small_problem(b)[0])
    rows = [[r.cost for r in s.iterations] for s in (s1, s2, s3)]
    assert rows[0] == rows[1] == rows[2]


def test_gradient_problem_on_card_matches_cpu(card):
    """The quaternion fit and Rosenbrock (LBFGS) through
    solve_gradient_problem on the card and the CPU: the answers within
    1e-12."""
    from ceres_tpu_torch import rotation as trot

    def fit(q):
        one = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64, device=q.device)
        z = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64, device=q.device)
        return torch.sum((trot.unit_quaternion_rotate_point(q, one) - z) ** 2)

    def rosen(x):
        return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] * x[0]) ** 2

    for fn, x0, man in ((fit, [1.0, 0.0, 0.0, 0.0], ctt.QuaternionManifold()),
                        (rosen, [-1.2, 1.0], None)):
        for loop in ("NEVER", "ALWAYS"):
            opts = ctt.Options(minimizer_type=ctt.MinimizerType.LINE_SEARCH, fused_loop=loop,
                               max_num_iterations=200)
            xc, xg = np.asarray(x0), np.asarray(x0)
            ctt.solve_gradient_problem(opts, ctt.GradientProblem(fn, len(x0), manifold=man),
                                       xc, device="cpu")
            s = ctt.solve_gradient_problem(opts, ctt.GradientProblem(fn, len(x0),
                                                                     manifold=man), xg)
            assert s.is_solution_usable()
            np.testing.assert_allclose(xg, xc, rtol=0, atol=1e-12)


# the example scripts at the arguments of the CPU tests
# (test_torch_examples_small.py, _models.py, _ba.py); libmv_bundle_adjuster.py
# on a file written as there
CARD_EXAMPLES = [
    ("helloworld", []), ("helloworld", ["--diff", "analytic"]),
    ("helloworld", ["--diff", "numeric"]), ("powell", []), ("curve_fitting", []),
    ("curve_fitting", ["--robust"]), ("circle_fit", []),
    ("circle_fit", ["--robust_threshold", "1.0"]), ("robot_pose_mle", []),
    ("rosenbrock", []), ("rosenbrock", ["--diff", "analytic"]),
    ("rosenbrock", ["--diff", "numeric"]), ("callbacks_example", []),
    ("evaluation_callback_example", []), ("libmv_homography", []),
    ("sampled_function", []), ("bicubic_interpolation", []),
    ("more_garbow_hillstrom", ["--problem", "1"]),
    ("more_garbow_hillstrom", ["--problem", "4", "--trials", "0,1"]),
    ("more_garbow_hillstrom", ["--problem", "7", "--constrained"]),
    ("pose_graph_2d", []), ("pose_graph_3d", []),
    ("ellipse_approximation", ["--num_points", "100", "--num_segments", "50"]),
    ("simple_bundle_adjuster", []),
    ("libmv_bundle_adjuster", ["LIBMV_FILE"]),
] + [("bundle_adjuster", ["--num_points", "200", "--num_iterations", "10"] + a)
     for a in ([], ["--linear_solver", "DENSE_SCHUR"], ["--linear_solver", "ITERATIVE_SCHUR"],
               ["--robustify"], ["--inner_iterations"])]


@pytest.mark.parametrize("name,argv", CARD_EXAMPLES,
                         ids=[" ".join([n] + a) for n, a in CARD_EXAMPLES])
def test_example_on_card_matches_cpu(card, monkeypatch, tmp_path, name, argv):
    """Each example script with --device cuda against its run with
    --device cpu: each solve's termination and rows the same, its final
    cost within 1e-9 relative (or 1e-12 x the initial cost where the CPU's
    lies below that)."""
    import importlib
    import io
    import sys

    import chip_smoke

    if "LIBMV_FILE" in argv:
        b = tbal.synthetic_bal(num_cameras=5, num_points=120, visibility=1.0, seed=0)
        argv = [str(tmp_path / "problem.bin")]
        chip_smoke.write_libmv_file(argv[0], chip_smoke.libmv_instance(
            b, tbal.perturb(b, 0.02, 0.2, 0.2, seed=1)))
    main = importlib.import_module(f"ceres_tpu_torch.examples.{name}").main
    runs = []
    for device in ("cpu", "cuda"):
        monkeypatch.setattr(sys, "stdin", io.StringIO(""))
        ret = main(argv + ["--device", device])
        runs.append(ret if isinstance(ret, list) else [ret])
    assert len(runs[1]) == len(runs[0])
    for c, g in zip(*runs):
        assert str(g.termination_type) == str(c.termination_type)
        assert len(g.iterations) == len(c.iterations)
        floor = 1e-12 * abs(c.initial_cost)
        tol = floor if abs(c.final_cost) < floor else 1e-9 * abs(c.final_cost)
        assert abs(g.final_cost - c.final_cost) <= tol, (g.final_cost, c.final_cost)


# -- port slice 18: covariance, TinySolver, capi, rotation, NIST, denoising -----


def _anchored_bal(w=1.0):
    """The 32-camera anchored BA of tests/test_torch_covariance.py."""
    b = tbal.synthetic_bal(num_cameras=32, num_points=150, visibility=0.15, noise=0.5, seed=0)
    prob, cams, pts = tbal.build_problem_batched(b)
    arr_c, arr_p = prob._block_arrays
    prob.add_residual_block_batch(ctt.AutoDiffCostFunction(lambda c, d: w * (c - d), 9, [9]),
                                  None, [(arr_c, np.arange(b.num_cameras))], data=cams.copy())
    prob.add_residual_block_batch(ctt.AutoDiffCostFunction(lambda p, d: w * (p - d), 3, [3]),
                                  None, [(arr_p, np.arange(b.num_points))], data=pts.copy())
    return prob


@pytest.mark.parametrize("kw", [dict(schur_tail_min_cols=128), dict(schur_tail_min_cols=0),
                                dict(use_normal_equations=True),
                                dict(algorithm_type=ctt.CovarianceAlgorithmType.DENSE_SVD)],
                         ids=["schur_tail", "qr", "normal_equations", "dense_svd"])
def test_covariance_on_card_matches_cpu(card, kw):
    """Each covariance path with J (and S, J'J) formed on the card against
    the same path on the CPU (1e-12 of the largest entry), the Schur tail
    and the normal equations launching their rows, no plain version."""
    prob = _anchored_bal()
    out = []
    for device in ("cpu", None):
        kn.reset_counts()
        cov = ctt.Covariance(ctt.CovarianceOptions(**kw))
        assert cov.compute([], prob, device=device)
        out.append(cov._cov)
    plain = {k.__name__: k.plain_calls for k in kn.KERNELS}
    launches = {k.__name__: k.launches for k in kn.KERNELS}
    assert not any(plain.values())
    if "schur_tail_min_cols" in kw and kw["schur_tail_min_cols"]:
        assert launches["segment_spread_sum"] > 0 and launches["segment_block_sum"] > 0
    if kw.get("use_normal_equations"):
        assert launches["segment_block_sum"] > 0 and launches["segment_block_expand"] > 0
    assert np.abs(out[1] - out[0]).max() <= 1e-12 * np.abs(out[0]).max()


def test_tiny_solver_on_card_matches_cpu(card):
    """solve_batch on 4,096 triangulations and solve on Rosenbrock: x within
    1e-13 and the iterations of the CPU's."""
    import chip_smoke
    from ceres_tpu_torch import rotation

    X, x0, cams, obs = chip_smoke.triangulations(4096)
    res = chip_smoke.triangulation_residual(rotation)
    (xg, sg), (xc, sc) = (ctt.TinySolver(res, device=d).solve_batch(x0, (cams, obs))
                          for d in (None, "cpu"))
    assert np.abs(xg.cpu().numpy() - xc.numpy()).max() <= 1e-13
    assert torch.equal(sg.iterations.cpu(), sc.iterations)

    def rosen(x, d):
        return torch.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])

    (xg, sg), (xc, sc) = (ctt.TinySolver(rosen, device=d).solve([-1.2, 1.0])
                          for d in (None, "cpu"))
    assert np.abs(xg.cpu().numpy() - xc.numpy()).max() <= 1e-13
    assert int(sg.iterations) == int(sc.iterations)


def test_capi_and_rotation_on_card(card):
    """The capi surface solves on the card; the five rotation functions of
    the slice on the card against the CPU (1e-13)."""
    from ceres_tpu_torch import capi
    from ceres_tpu_torch import rotation as rot

    p = capi.ceres_create_problem()
    x = np.zeros(2)
    capi.ceres_problem_add_residual_block(
        p, lambda v: v - torch.tensor([1.0, 2.0], dtype=v.dtype, device=v.device), 2, [2], [x],
        loss_function_name="cauchy")
    s = capi.ceres_solve(p)
    assert s.is_solution_usable() and s.device_kind == torch.cuda.get_device_name(card)
    np.testing.assert_allclose(x, [1.0, 2.0], atol=1e-6)
    aa = torch.as_tensor(np.random.default_rng(3).standard_normal((512, 3)))
    for fn in (rot.angle_axis_to_rotation_matrix, rot.cross_product_matrix,
               rot.euler_angles_to_rotation_matrix,
               torch.func.vmap(lambda v: rot.euler_angles_to_rotation("ExtrinsicZXZ", v))):
        g, c = fn(aa.to(card)).cpu(), fn(aa)
        assert (g - c).abs().max() <= 1e-13 * c.abs().max()
    R = rot.angle_axis_to_rotation_matrix(0.5 * aa)
    inv = torch.func.vmap(lambda M: rot.rotation_matrix_to_euler_angles("IntrinsicYXZ", M))
    assert (inv(R.to(card)).cpu() - inv(R)).abs().max() <= 1e-13


def test_nist_and_denoising_on_card_match_cpu(card, tmp_path):
    """examples/nist.py on one NIST-format file and examples/denoising.py
    on a 24x24 image (5 CGNR iterations, the flat path's rows 6 and 7) on
    the card against the CPU: final costs within 1e-10, the same rows."""
    import chip_smoke
    from ceres_tpu_torch.examples import denoising as den_example
    from ceres_tpu_torch.examples import nist as nist_example
    from ceres_tpu_torch.models import denoising

    chip_smoke.write_nist_file(tmp_path / "Rat42.dat", "Rat42")
    runs = [nist_example.main(["--nist_data_dir", str(tmp_path), "--problem", "Rat42.dat",
                               "--device", d]) for d in ("cpu", "cuda")]
    for c, g in zip(*runs):
        assert abs(g.final_cost - c.final_cost) <= 1e-10 * c.final_cost
    chip_smoke.write_foe_file(tmp_path / "m.foe")
    denoising.write_pgm(tmp_path / "n.pgm", chip_smoke.noisy_image(24))
    kn.reset_counts()
    runs = [den_example.main(["--input", str(tmp_path / "n.pgm"), "--foe_file",
                              str(tmp_path / "m.foe"), "--output", str(tmp_path / "o.pgm"),
                              "--num_iterations", "5", "--device", d]) for d in ("cpu", "cuda")]
    assert len(runs[0].iterations) == len(runs[1].iterations)
    for c, g in zip(runs[0].iterations, runs[1].iterations):
        assert abs(g.cost - c.cost) <= 1e-10 * runs[0].initial_cost
    assert kn.segment_block_sum.launches > 0 and kn.segment_block_expand.launches > 0


@pytest.mark.parametrize("solver", ["DENSE_SCHUR", "ITERATIVE_SCHUR"])
def test_solve_on_a_second_card_matches_the_first(card, solver):
    """solve(..., device="cuda:1") with card 0 current: every kernel
    launches on card 1 (kernels._launch makes the tensors' card current),
    the same costs as on card 0 bit for bit, the same launches, and
    nothing allocated on card 0. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    b = small_bal()
    arrays = (b.cameras, b.points, b.camera_index, b.point_index, b.observations)
    opts = ctt.Options(fused_loop="ALWAYS",
                       linear_solver_type=getattr(ctt.LinearSolverType, solver))
    runs = []
    for d in ("cuda:0", "cuda:1"):
        problem = tbal.build_problem_batched(tbal.from_arrays(*arrays))[0]
        torch.cuda.synchronize(0)
        base = torch.cuda.memory_allocated(0)
        torch.cuda.reset_peak_memory_stats(0)
        kn.reset_counts()
        s = ctt.solve(opts, problem, device=d)
        torch.cuda.synchronize(d)
        runs.append((s, {k.__name__: k.launches for k in kn.KERNELS},
                     torch.cuda.max_memory_allocated(0) - base))
    (s0, l0, _), (s1, l1, card0_bytes) = runs
    assert torch.cuda.current_device() == 0
    assert [r.cost for r in s1.iterations] == [r.cost for r in s0.iterations]
    assert l1 == l0 and any(l1.values())
    assert card0_bytes == 0
