"""The CGNR step of ceres_tpu_torch (solvers/fused_lm.CgnrStepOps over
ops/flatops.FlatJacobianOps) against ceres_tpu on the same inputs, on the
CPU (the kernels' plain versions): the flat products J x, J'u and the
fused post-evaluation, the scale-folded (J_s'J_s) x of normal_matvec
(kernel 4), the whole solve with the JACOBI and IDENTITY preconditioners,
the fallback of ITERATIVE_SCHUR to CGNR on a problem without eliminable
blocks, and CGNR on the libmv bundle adjuster through the flat chain. Each
solve passes fused_loop="ALWAYS" in both packages (their AUTO sends
problems this small to the host loop, which tests/test_torch_trust_region.py
holds). Each tolerance is stated where it is used."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu.models import bal as jbal
from ceres_tpu.models import libmv as jlibmv
from ceres_tpu.models import mgh as jmgh
from ceres_tpu.ops import bsr as jbsr
from ceres_tpu.ops.flatops import FlatJacobianOps as JaxFlatJacobianOps
from ceres_tpu.program import CompiledProgram as JaxProgram

import ceres_tpu_torch as ctt
import chip_smoke
from ceres_tpu_torch.models import libmv as tlibmv
from ceres_tpu_torch.models import mgh as tmgh
from ceres_tpu_torch.ops import kernels as kn
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.solvers.fused_lm import CgnrStepOps
from test_torch_dense_step import assert_rows_match, ba, jax_ba, port_ba
from test_torch_libmv import jax_lp, small_libmv

CGNR = ctt.LinearSolverType.CGNR
TOL = {"float64": 1e-12, "float32": 1e-5}


def rel_err(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module", params=["float64", "float32"])
def flat_setup(request):
    """The JAX FlatJacobianOps on the flattened blocks of the 6-camera,
    60-point BA problem at its initial state (rows sorted by point, as the
    port sorts them), and the port's CGNR step on the same problem."""
    dtype = request.param
    b = ba()
    jprog = JaxProgram(jax_ba(b), compute_dtype=dtype, sort_rows=True)
    o = jprog._eval_core(jprog.initial_state(), True, False, need_grad=False)
    jfl = JaxFlatJacobianOps(jbsr.build_meta(jprog))
    prog = CompiledProgram(port_ba(b), dtype, device="cpu")
    ops = CgnrStepOps(prog, ctt.Options(linear_solver_type=CGNR))
    _, vrep = ops.evaluate(prog.initial_state())
    return dict(dtype=dtype, jfl=jfl, vflat=jfl.flatten(o["block_jacs"]),
                r=o["residuals"], ops=ops, vrep=vrep, T=prog.tangent_size,
                N=prog.num_residuals, tdt=prog.compute_dtype)


def _vec(rng, n, s):
    v = rng.standard_normal(n)
    return jnp.asarray(v, s["dtype"]), torch.as_tensor(v, dtype=s["tdt"])


def test_right_and_left_match_jax(flat_setup):
    """J x and J'u against the JAX flat chain on the same Jacobian: 1e-12
    relative in float64, 1e-5 in float32 (the two evaluations differ in
    the rotation's branch-free form by ~1e-13 relative)."""
    s = flat_setup
    rng = np.random.default_rng(5)
    fl, vflat = s["ops"].flat, s["vrep"].vflat
    xj, xt = _vec(rng, s["T"], s)
    uj, ut = _vec(rng, s["N"], s)
    assert rel_err(fl.right(vflat, xt), s["jfl"].right(s["vflat"], xj)) <= TOL[s["dtype"]]
    assert rel_err(fl.left(vflat, ut), s["jfl"].left(s["vflat"], uj)) <= TOL[s["dtype"]]


def test_fused_post_eval_all_matches_jax(flat_setup):
    """The gradient J'r, diag(J'J) and each family's J'J blocks from one
    reduction per slot: 1e-12 relative in float64, 1e-5 in float32."""
    s = flat_setup
    g, sqn, blocks = s["ops"].post_eval(s["vrep"])
    g_ref, sqn_ref, blocks_ref = s["jfl"].fused_post_eval_all(s["vflat"], s["r"])
    tol = TOL[s["dtype"]]
    assert rel_err(g, g_ref) <= tol
    assert rel_err(sqn, sqn_ref) <= tol
    assert len(blocks) == len(blocks_ref) == 2
    for blk, ref in zip(blocks, blocks_ref):
        assert rel_err(blk, np.asarray(ref)[:blk.shape[0], :blk.shape[1]]) <= tol


def test_kernel_matvec_matches_the_jax_chain(flat_setup):
    """(J_s'J_s) x through normal_matvec (its plain version here), the
    Jacobi scales folded into its small operands, against the JAX chain
    s * J'(J (s * x)): 1e-12 relative in float64, 1e-5 in float32. The
    BAL program qualifies for the kernel in both dtypes."""
    s = flat_setup
    rng = np.random.default_rng(6)
    fl = s["ops"].flat
    assert s["vrep"].jt is not None and tuple(s["vrep"].jt.shape) == (kn.LANES, fl.plan.B)
    sj, st = _vec(rng, s["T"], s)
    sj, st = jnp.abs(sj) + 0.5, torch.abs(st) + 0.5
    xj, xt = _vec(rng, s["T"], s)
    kn.reset_counts()
    out = fl.make_kernel_matvec(s["vrep"].jt, st)(xt)
    assert kn.normal_matvec.plain_calls == 1 and kn.normal_matvec.launches == 0
    ref = sj * s["jfl"].left(s["vflat"], s["jfl"].right(s["vflat"], sj * xj))
    assert out.dtype == s["tdt"]
    assert rel_err(out, ref) <= TOL[s["dtype"]]


def test_flat_chain_takes_a_program_the_kernel_does_not():
    """The libmv model (three slots) has no kernel lanes: its CGNR matvec is
    the right/left chain."""
    prog = CompiledProgram(tlibmv.build_problem(chip_smoke.fresh(small_libmv()))[0],
                           device="cpu")
    ops = CgnrStepOps(prog, ctt.Options(linear_solver_type=CGNR))
    _, vrep = ops.evaluate(prog.initial_state())
    assert ops.flat.kernel_slots is None and ops.flat.plan is None and vrep.jt is None
    assert ops.flat.make_kernel_matvec(vrep.jt, torch.ones(prog.tangent_size)) is None


def _cgnr_pair(b, prec, dtype="float64"):
    ref = ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType.CGNR,
                              preconditioner_type=ct.PreconditionerType[prec],
                              evaluation_dtype=dtype, fused_loop="ALWAYS"), jax_ba(b))
    kn.reset_counts()
    s = ctt.solve(ctt.Options(fused_loop="ALWAYS", linear_solver_type=CGNR,
                              preconditioner_type=ctt.PreconditionerType[prec],
                              evaluation_dtype=dtype), port_ba(b), device="cpu")
    return ref, s, {k.__name__: k.plain_calls for k in kn.KERNELS}


@pytest.fixture(scope="module")
def solved():
    b = ba()
    return b, {prec: _cgnr_pair(b, prec) for prec in ("JACOBI", "IDENTITY")}


def test_cgnr_jacobi_matches_jax_row_for_row(solved):
    """JACOBI on the 6-camera, 60-point problem: the same termination, rows
    and CG count of every row; each row's cost and radius to 1e-9
    relative."""
    _, res = solved
    ref, out, _ = res["JACOBI"]
    assert out.termination_type.name == ref.termination_type.name == "CONVERGENCE"
    assert_rows_match(out, ref)
    assert [r.linear_solver_iterations for r in out.iterations][:6] == [0, 3, 5, 8, 3, 29]
    assert out.linear_solver_type_used.name == ref.linear_solver_type_used.name == "CGNR"
    assert out.preconditioner_type_used.name == ref.preconditioner_type_used.name == "JACOBI"


def test_cgnr_identity_matches_jax_as_far_as_cg_repeats(solved):
    """IDENTITY: unpreconditioned CG on J'J of a BA problem needs 50 to 200
    iterations from the fifth row on, and its iterate there follows
    rounding (the two evaluations differ by ~1e-13 relative, and the port's
    product is normal_matvec's, summed in another order than the JAX
    chain): the CG counts part there. The rows before agree to 1e-9 with
    the same CG counts, and both solves converge."""
    _, res = solved
    ref, out, _ = res["IDENTITY"]
    rows = list(zip(ref.iterations, out.iterations))[:4]
    assert [a.linear_solver_iterations for a, _ in rows] == [0, 4, 9, 17]
    for a, c in rows:
        assert c.linear_solver_iterations == a.linear_solver_iterations
        assert c.cost == pytest.approx(a.cost, rel=1e-9)
        assert c.trust_region_radius == pytest.approx(a.trust_region_radius, rel=1e-9)
    assert out.termination_type.name == ref.termination_type.name == "CONVERGENCE"
    assert out.preconditioner_type_used.name == ref.preconditioner_type_used.name == "IDENTITY"


@pytest.mark.parametrize("prec", ["JACOBI", "IDENTITY"])
def test_cgnr_counts_kernels_and_host_syncs(solved, prec):
    """On the CPU the CGNR path runs the plain versions of normal_matvec
    (once per CG iteration, and once more for each CG's first residual),
    of the segment sums (the post-evaluation, once per evaluation) and of
    the gather (J x of the model cost change); no kernel of the jt or dense
    Schur paths. The host syncs once per LM iteration, once before the
    first and once per CG iteration."""
    _, res = solved
    _, out, plain = res[prec]
    n_it = len(out.iterations) - 1
    cg = sum(r.linear_solver_iterations for r in out.iterations)
    assert out.num_host_syncs == n_it + 1 + cg
    assert plain["normal_matvec"] >= cg + n_it
    for name in ("segment_block_sum", "unsorted_segment_sum", "segment_block_expand"):
        assert plain[name] >= n_it, name
    for name in ("eval_fused", "post_eval_fused", "isc_matvec", "schur_jacobi_blocks",
                 "schur_assembly", "segment_spread_sum"):
        assert plain[name] == 0, name


def test_schur_jacobi_runs_as_jacobi_on_cgnr(solved):
    """CGNR's SCHUR_JACOBI is the block-Jacobi preconditioner of J'J, as
    JACOBI (fused_lm.py:161): the same rows bit for bit; the type used is
    the given one."""
    b, res = solved
    s = ctt.solve(ctt.Options(fused_loop="ALWAYS", linear_solver_type=CGNR,
                              preconditioner_type=ctt.PreconditionerType.SCHUR_JACOBI),
                  port_ba(b), device="cpu")
    assert [r.cost for r in s.iterations] == [r.cost for r in res["JACOBI"][1].iterations]
    assert s.preconditioner_type_used == ctt.PreconditionerType.SCHUR_JACOBI


def test_cgnr_float32_reaches_the_float64_cost():
    """evaluation_dtype="float32" runs the same path, normal_matvec in
    float32: its final cost within 1e-5 relative of the float64 solve's,
    and of the JAX package's float32 CGNR. The problem is the 6-camera,
    60-point one with pixel noise 1.0, as BAL-16's: at noise 0.1 the final
    cost (0.68 over 240 residuals) lies within float32's own rounding of
    the residuals (~3e-5 relative)."""
    b = jbal.perturb(jbal.synthetic_bal(num_cameras=6, num_points=60, visibility=0.5,
                                        noise=1.0, seed=3), 0.01, 0.05, 0.05)
    ref32, s32, plain = _cgnr_pair(b, "JACOBI", "float32")
    s64 = _cgnr_pair(b, "JACOBI")[1]
    assert s32.is_solution_usable()
    assert plain["normal_matvec"] > 0
    assert s32.final_cost == pytest.approx(s64.final_cost, rel=1e-5)
    assert s32.final_cost == pytest.approx(ref32.final_cost, rel=1e-5)


@pytest.mark.parametrize("prec,number", [("IDENTITY", 1), ("JACOBI", 10)])
def test_iterative_schur_without_e_blocks_falls_back_to_cgnr(prec, number):
    """ITERATIVE_SCHUR on an MGH problem (one parameter block: no
    eliminable block set) runs CGNR, as LinearSolverForZeroEBlocks makes
    the JAX package do. On these small, well-conditioned systems CG repeats
    exactly: the same rows and CG counts, each cost to 1e-9 relative or
    1e-20 absolute, each radius to 1e-9; the solver used is CGNR and the
    preconditioner used the given one. (Meyer, #10, stops at 100 rows.)"""
    kw = dict(preconditioner_type=prec, max_num_iterations=100)
    _, _, ref = jmgh.solve_problem(jmgh.PROBLEMS[number - 1], options_overrides=dict(
        kw, linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR, fused_loop="ALWAYS",
        preconditioner_type=ct.PreconditionerType[prec]))
    _, _, out = tmgh.solve_problem(tmgh.PROBLEMS[number - 1], device="cpu",
                                   options_overrides=dict(
                                       kw, linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR,
                                       preconditioner_type=ctt.PreconditionerType[prec]))
    assert out.linear_solver_type_used.name == ref.linear_solver_type_used.name == "CGNR"
    assert out.preconditioner_type_used.name == ref.preconditioner_type_used.name == prec
    assert_rows_match(out, ref, abs_=1e-20)


def test_libmv_cgnr_takes_the_flat_chain_and_matches_jax():
    """CGNR with JACOBI on the libmv model (5 cameras, 120 points, one shared
    intrinsics block): the same termination, rows and CG counts as the JAX
    package's; each row's cost and radius within 1e-9 relative, or 4x
    the JAX package's own sensitivity to rounding where that is larger:
    the change of its row from cameras one ulp away. From row 6 on a CG
    of ~30 iterations turns rounding into ~1e-7 of the cost and, through
    a cost change of 6e-4 relative, ~7e-4 of the radius in the JAX package
    itself. The products run through the segment sums and the gather,
    normal_matvec never."""
    lp = small_libmv()
    ulp = chip_smoke.fresh(lp)
    ulp.cameras = np.nextafter(lp.cameras, np.inf)
    ref, ref_ulp = (ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType.CGNR,
                                        fused_loop="ALWAYS"),
                             jlibmv.build_problem(jax_lp(p))[0]) for p in (lp, ulp))
    kn.reset_counts()
    out = ctt.solve(ctt.Options(fused_loop="ALWAYS", linear_solver_type=CGNR),
                    tlibmv.build_problem(chip_smoke.fresh(lp))[0], device="cpu")
    assert out.termination_type.name == ref.termination_type.name
    assert len(out.iterations) == len(ref.iterations) == len(ref_ulp.iterations)
    for a, u, c in zip(ref.iterations, ref_ulp.iterations, out.iterations):
        assert c.linear_solver_iterations == a.linear_solver_iterations
        for key in ("cost", "trust_region_radius"):
            ra, ru, rc = getattr(a, key), getattr(u, key), getattr(c, key)
            assert abs(rc - ra) <= max(1e-9, 4 * abs(ru - ra) / abs(ra)) * abs(ra), key
    n_it = len(out.iterations) - 1
    cg = sum(r.linear_solver_iterations for r in out.iterations)
    assert kn.normal_matvec.plain_calls == 0
    assert kn.segment_block_expand.plain_calls >= cg
    for k in (kn.segment_block_sum, kn.unsorted_segment_sum):
        assert k.plain_calls >= cg + n_it, k.__name__
