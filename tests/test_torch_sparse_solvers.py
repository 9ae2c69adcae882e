"""The port's sparse direct solvers and SUBSET (ops/inner_product.py,
solvers/linear/sparse_normal.py, sparse_schur.py, preconditioners.py, the
sparse steps of solvers/bsr_kernels.py) against the JAX package's on the
CPU: the values of J'J + D^2 and of the Schur complement S against the
JAX functions and the dense matrices (1e-12), the eliminator's pair sets,
and solves in the host loop of both packages on small BAL problems
(SPARSE_SCHUR, SPARSE_NORMAL_CHOLESKY static, dynamic and with
mixed-precision solves, CGNR + SUBSET, ITERATIVE_SCHUR + SUBSET): the
same rows, each row's cost within 1e-10 relative, the same CG counts;
the fallback of SPARSE_SCHUR without e-blocks; a failed factorization
handled as the JAX package handles it. Each tolerance is stated where it
is used."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import ceres_tpu as ct
import chip_smoke
from ceres_tpu.models import bal as jbal
from ceres_tpu.models import libmv as jlibmv
from ceres_tpu.ops import bsr as jbsr
from ceres_tpu.ops import partition as jpt
from ceres_tpu.ops.inner_product import InnerProductComputer as JaxInnerProduct
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers.linear import sparse_schur as jss
from ceres_tpu.utils import ordering as jordering

import ceres_tpu_torch as ctt
from ceres_tpu_torch import native
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.models import libmv as tlibmv
from ceres_tpu_torch.ops import bsr
from ceres_tpu_torch.ops import flatops as fo
from ceres_tpu_torch.ops import partition as pt
from ceres_tpu_torch.ops.inner_product import InnerProductComputer
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.solvers.linear import sparse_schur as tss
from ceres_tpu_torch.solvers.linear.dense_schur import DenseSchurOps
from ceres_tpu_torch.utils import ordering
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-12


def _bal_problems():
    """A small BAL problem built per block, camera 0 held constant."""
    b = jbal.perturb(jbal.synthetic_bal(num_cameras=4, num_points=40, visibility=0.5,
                                        noise=0.3, seed=5), 0.05, 0.2, 0.2)
    jp, jcams, _ = jbal.build_problem(b)
    jp.set_parameter_block_constant(jcams[0])
    tp, tcams, _ = tbal.build_problem(tbal.from_arrays(
        b.cameras, b.points, b.camera_index, b.point_index, b.observations))
    tp.set_parameter_block_constant(tcams[0])
    return jp, tp


def _libmv_problems():
    """libmv's model: a camera, a point and the shared intrinsics a marker."""
    b = tbal.synthetic_bal(num_cameras=4, num_points=40, visibility=1.0, seed=0)
    lp = chip_smoke.libmv_instance(b, tbal.perturb(b, 0.02, 0.2, 0.2, seed=1))
    jp = ct.Problem()
    cams = jp.add_parameter_block_array(lp.cameras.copy())
    pts = jp.add_parameter_block_array(lp.points.copy())
    intr = jp.add_parameter_block_array(lp.intrinsics.reshape(1, 8).copy())
    jp.add_residual_block_batch(
        ct.AutoDiffCostFunction(jlibmv.libmv_reprojection_residual, 2, [6, 3, 8]), None,
        [(cams, lp.marker_cam), (pts, lp.marker_pt),
         (intr, np.zeros(lp.marker_cam.shape[0], np.int64))], data=lp.markers)
    return jp, tlibmv.build_problem(chip_smoke.fresh(lp))[0]


@pytest.fixture(scope="module", params=["bal", "libmv"])
def setup(request):
    """(JAX meta, partition, values; the port's meta, partition, the same
    values flattened; dense J, residuals, e columns) at the initial state."""
    jp, tp = {"bal": _bal_problems, "libmv": _libmv_problems}[request.param]()
    jprog = JaxProgram(jp, sort_rows=True)
    _, res, _, jvalues = jprog.evaluate_bsr(jprog.initial_state())
    jmeta = jbsr.build_meta(jprog)
    jpm = jpt.build_partition(jmeta, jordering.eligible_e_sets(jprog))
    prog = CompiledProgram(tp, device="cpu")
    meta = bsr.build_meta(prog)
    pm = pt.build_partition(meta, ordering.eligible_e_sets(prog))
    vflat = fo._FlatOpsBase.flatten([[torch.as_tensor(np.array(V)) for V in slots]
                                     for slots in jvalues])
    J = np.asarray(jbsr.to_dense(jmeta, jvalues))
    e_cols = np.zeros(J.shape[1], bool)
    for fi in jpm.e_family_indices:
        f = jmeta.families[fi]
        e_cols[f.tangent_offset:f.tangent_offset + f.num_var * f.t] = True
    return jmeta, jpm, jvalues, meta, pm, vflat, J, np.array(res), e_cols


def _close(out, ref, tol=TOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1.0)


def _csr(vals, indptr, indices, n):
    return sp.csr_matrix((np.asarray(vals, np.float64), indices, indptr), shape=(n, n)).toarray()


def test_inner_product_matches_jax_and_dense(setup):
    """J'J + D^2: the JAX pattern (indptr, indices) exactly, the values
    1e-12 relative against the JAX class's and against the dense J; a
    second computation bit for bit the first (no atomics)."""
    jmeta, _, jvalues, meta, _, vflat, J, _, _ = setup
    D = np.random.default_rng(5).uniform(0.5, 1.5, meta.tangent_size)
    ref = JaxInnerProduct(jmeta)
    ipc = InnerProductComputer(meta, "cpu")
    assert np.array_equal(ipc.indptr, ref.indptr) and np.array_equal(ipc.indices, ref.indices)
    vals = ipc.compute(vflat, torch.as_tensor(D))
    _close(vals, ref.compute(jvalues, jnp.asarray(D)))
    _close(_csr(vals, ipc.indptr, ipc.indices, ipc.n), J.T @ J + np.diag(D * D))
    assert torch.equal(vals, ipc.compute(vflat, torch.as_tensor(D)))


def test_enumerate_schur_pairs_matches_jax(setup):
    """The F'F slot pairs, the buckets and each bucket's (row a, row b,
    e-block) triples: the JAX function's, in its order."""
    _, jpm, _, _, pm, _, _, _, _ = setup
    jftf, jbuckets, je = jss.enumerate_schur_pairs(jpm)
    ftf, buckets, e = tss.enumerate_schur_pairs(pm)
    assert ftf == jftf and e == je
    assert list(buckets) == list(jbuckets)
    for key, (ia, ib, eb) in buckets.items():
        ja, jb, jeb = jbuckets[key]
        assert np.array_equal(ia, ja) and np.array_equal(ib, jb) and np.array_equal(eb, jeb)


def test_schur_complement_values_match_jax_and_dense(setup):
    """The values of S: the JAX pattern exactly, 1e-12 relative against
    SparseSchurSolver._numeric_impl and against the port's dense S
    (DENSE_SCHUR's assembly); a second assembly bit for bit the first."""
    _, jpm, jvalues, _, pm, vflat, J, res, e_cols = setup
    D = np.random.default_rng(3).uniform(0.1, 1.0, J.shape[1])
    D_e, D_f = pt.extract_e(pm, torch.as_tensor(D)), pt.extract_f(pm, torch.as_tensor(D))
    ref = jss.SparseSchurSolver(jpm)
    fl = fo.FlatSchurOps(pm, "cpu")
    sss = tss.SparseSchurSolver(pm, fl)
    assert np.array_equal(sss.indptr, ref.indptr) and np.array_equal(sss.indices, ref.indices)
    minv = fl.inverse_flats(pm.e_fams, fl.block_ete(vflat), D_e)
    vals = sss.values(vflat, minv, D_f)
    _close(vals, ref._numeric_impl(jvalues, jnp.asarray(D_e.numpy()), jnp.asarray(D_f.numpy())))
    dense = DenseSchurOps(pm, fl)
    W = dense.assemble_w(vflat)
    Minv_W = torch.cat([
        (minv[i].reshape(nv, t, t) @ W[off:off + nv * t].reshape(nv, t, -1)).reshape(nv * t, -1)
        for i, (off, nv, t, _) in enumerate(pm.e_fams)])
    S = dense.assemble_ftf(vflat) + torch.diag(D_f * D_f) - W.T @ Minv_W
    _close(_csr(vals, sss.indptr, sss.indices, pm.f_size), S)
    assert torch.equal(vals, sss.values(vflat, minv, D_f))


# --------------------------------------------------------------------------
# solves against the JAX host loop
# --------------------------------------------------------------------------


def _arrays(b):
    return (b.cameras.copy(), b.points.copy(), b.camera_index.copy(), b.point_index.copy(),
            b.observations.copy())


def small_bal(num_cameras=4, num_points=200, visibility=0.5, seed=0):
    b = jbal.synthetic_bal(num_cameras=num_cameras, num_points=num_points,
                           visibility=visibility, seed=seed)
    return jbal.perturb(b, 0.01, 0.05, 0.05, seed=1)


def _batched(pkg, b):
    if pkg is ct:
        return jbal.build_problem_batched(jbal.BALProblem(*_arrays(b)))[0]
    return tbal.build_problem_batched(tbal.from_arrays(*_arrays(b)))[0]


def _per_block(pkg, b):
    if pkg is ct:
        return jbal.build_problem(jbal.BALProblem(*_arrays(b)))[0]
    return tbal.build_problem(tbal.from_arrays(*_arrays(b)))[0]


def _options(pkg, kw):
    kw = dict(kw)
    for name, enum in (("linear_solver_type", pkg.LinearSolverType),
                       ("preconditioner_type", pkg.PreconditionerType)):
        if name in kw:
            kw[name] = enum[kw[name]]
    return pkg.Options(**kw)


def both(b, kw, build=_batched, options=None):
    """(JAX summary, port summary) of one option set from the same start,
    each package's host loop (both pick it: under 8,192 residuals)."""
    out = []
    for pkg in (ct, ctt):
        problem = build(pkg, b)
        opts = options(pkg, problem) if options else _options(pkg, kw)
        extra = {} if pkg is ct else {"device": "cpu"}
        out.append(pkg.solve(opts, problem, **extra))
    return out


def same_rows(ref, s, cg=True):
    """The same rows, each cost within 1e-10 relative (1e-30 absolute for
    the row a tolerance closes, which holds 0 in both), the same CG
    counts and step outcomes."""
    assert s.termination_type.name == ref.termination_type.name
    assert len(s.iterations) == len(ref.iterations)
    for a, c in zip(ref.iterations, s.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-10, abs=1e-30)
        assert c.step_is_successful == a.step_is_successful
        assert c.step_is_valid == a.step_is_valid
        if cg:
            assert c.linear_solver_iterations == a.linear_solver_iterations
    assert s.final_cost == pytest.approx(ref.final_cost, rel=1e-10)
    assert s.linear_solver_type_used.name == ref.linear_solver_type_used.name
    assert s.preconditioner_type_used.name == ref.preconditioner_type_used.name


@pytest.mark.parametrize("kw", [
    dict(linear_solver_type="SPARSE_SCHUR"),
    dict(linear_solver_type="SPARSE_NORMAL_CHOLESKY"),
    dict(linear_solver_type="SPARSE_NORMAL_CHOLESKY", dynamic_sparsity=True),
    dict(linear_solver_type="SPARSE_NORMAL_CHOLESKY", use_mixed_precision_solves=True,
         max_num_refinement_iterations=3),
], ids=["sparse_schur", "snc", "snc_dynamic", "snc_mixed"])
def test_sparse_solves_match_jax(kw):
    """Each sparse solver on a 4-camera BAL problem in both host loops, and
    a repeat of the port's solve bit for bit (the assembly sums in a fixed
    order)."""
    b = small_bal()
    ref, s = both(b, kw)
    same_rows(ref, s)
    assert s.termination_type.name == "CONVERGENCE"
    again = ctt.solve(_options(ctt, kw), _batched(ctt, b), device="cpu")
    assert [r.cost for r in again.iterations] == [r.cost for r in s.iterations]


def test_default_options_run_sparse_normal_cholesky():
    """Options() takes SPARSE_NORMAL_CHOLESKY, in the host loop (one host
    sync brings J'J and J'r to the host each step), as the JAX package."""
    b = small_bal()
    ref, s = both(b, {})
    same_rows(ref, s)
    assert s.linear_solver_type_used == ctt.LinearSolverType.SPARSE_NORMAL_CHOLESKY
    assert s.num_host_syncs > 2 * len(s.iterations)


def test_sparse_schur_per_block_with_constant_camera():
    """SPARSE_SCHUR on a problem built one block at a time, camera 0 held
    constant (a constant f-block in the pairs), against the JAX host loop."""
    b = small_bal(seed=2)

    def build(pkg, b):
        p = _per_block(pkg, b)
        arr = [blk for blk in p.parameter_blocks() if blk.size == 9][0]
        p.set_parameter_block_constant(arr.values)
        return p

    same_rows(*both(b, dict(linear_solver_type="SPARSE_SCHUR"), build=build))


def _subset_ids(problem, b, drop=8):
    """The residual blocks but one observation of each of the first `drop`
    points seen at least 6 times: a well-conditioned subset
    (tests/test_bal_golden.py:104-143)."""
    counts = np.bincount(b.point_index, minlength=b.num_points)
    dropped, keep = set(), []
    for rb, p in zip(problem.residual_blocks(), b.point_index):
        if counts[p] >= 6 and p not in dropped and len(dropped) < drop:
            dropped.add(p)
            continue
        keep.append(rb.rb_id)
    return keep


def test_cgnr_subset_matches_jax():
    """CGNR with SUBSET on an 8-camera BAL problem built per block (the same
    residual block ids in both packages), eta 1e-2: the same rows, costs
    and CG counts; the preconditioner reported as SUBSET; one host sync a
    CG iteration for the preconditioner's apply besides the CG's own."""
    b = small_bal(num_cameras=8, num_points=150, visibility=0.8)
    ids = {}

    def options(pkg, problem):
        ids[pkg] = _subset_ids(problem, b)
        return _options(pkg, dict(linear_solver_type="CGNR", preconditioner_type="SUBSET",
                                  residual_blocks_for_subset_preconditioner=ids[pkg],
                                  eta=1e-2))

    ref, s = both(b, None, build=_per_block, options=options)
    assert ids[ct] == ids[ctt] and len(ids[ct]) < b.num_observations
    same_rows(ref, s)
    assert s.preconditioner_type_used == ctt.PreconditionerType.SUBSET
    cg = sum(r.linear_solver_iterations for r in s.iterations)
    assert cg > len(s.iterations) and s.num_host_syncs >= 2 * cg


@pytest.mark.parametrize("kw", [
    dict(linear_solver_type="ITERATIVE_SCHUR", preconditioner_type="SUBSET"),
    dict(linear_solver_type="CGNR", preconditioner_type="SUBSET"),
], ids=["iterative_schur", "cgnr_without_residual_blocks"])
def test_subset_runs_as_identity_where_jax_does(kw):
    """ITERATIVE_SCHUR with SUBSET, and CGNR with SUBSET but no residual
    blocks, run as IDENTITY in the JAX host loop: the port's rows are those
    rows (with SUBSET reported as the preconditioner, as there), and those
    of the port's IDENTITY solve bit for bit. Unpreconditioned CG on BA runs
    tens of iterations a row, amplifying the rounding of two summation
    orders (the third row's 25 iterations part the packages by 6e-6): the
    first 3 rows are compared."""
    kw = dict(kw, max_num_iterations=2)
    b = small_bal()
    ref, s = both(b, kw)
    same_rows(ref, s)
    ident = ctt.solve(_options(ctt, dict(kw, preconditioner_type="IDENTITY")),
                      _batched(ctt, b), device="cpu")
    assert [r.cost for r in ident.iterations] == [r.cost for r in s.iterations]


def _curve_fit(pkg, exp):
    rng = np.random.default_rng(0)
    xs = np.linspace(0, 5, 67)
    ys = np.exp(0.3 * xs + 0.1) + 0.2 * rng.standard_normal(67)
    cost = pkg.AutoDiffCostFunction(lambda mc, d: d[1] - exp(mc[0] * d[0] + mc[1]), 1, [2])
    p = pkg.Problem()
    mc = np.zeros(2)
    for x, y in zip(xs, ys):
        p.add_residual_block(cost, None, [mc], data=(np.float64(x), np.float64(y)))
    return p


def test_sparse_schur_without_e_blocks_falls_back():
    """A curve fit has no e-blocks: SPARSE_SCHUR falls back to
    SPARSE_NORMAL_CHOLESKY in both packages, with the same rows."""
    out = []
    for pkg, fn in ((ct, jnp), (ctt, torch)):
        extra = {} if pkg is ct else {"device": "cpu"}
        out.append(pkg.solve(_options(pkg, dict(linear_solver_type="SPARSE_SCHUR")),
                             _curve_fit(pkg, fn.exp), **extra))
    ref, s = out
    same_rows(ref, s)
    assert s.linear_solver_type_used == ctt.LinearSolverType.SPARSE_NORMAL_CHOLESKY


@pytest.mark.parametrize("lst", ["SPARSE_NORMAL_CHOLESKY", "SPARSE_SCHUR"])
def test_failed_factorization_is_the_jax_rejected_step(monkeypatch, lst):
    """Where the factorization fails (here its first two numeric calls, in
    both packages), the step is NaN and the loop counts it invalid: the
    JAX rows (invalid, the radius halved twice) and the same solve after."""
    import ceres_tpu.native as jnative

    for mod, cls in ((jnative, jnative.SparseCholesky), (native, native.SparseCholesky)):
        calls = {"n": 0}
        orig = cls.factorize

        def failing(self, values, orig=orig, calls=calls):
            calls["n"] += 1
            return False if calls["n"] <= 2 else orig(self, values)

        monkeypatch.setattr(cls, "factorize", failing)
    ref, s = both(small_bal(), dict(linear_solver_type=lst))
    same_rows(ref, s)
    assert [r.step_is_valid for r in s.iterations[1:3]] == [False, False]
    assert s.iterations[2].trust_region_radius == pytest.approx(
        s.iterations[0].trust_region_radius / 8)


def test_subset_needs_residual_block_ids():
    """A batch of residual blocks has no per-row ids to select by."""
    b = small_bal()
    opts = _options(ctt, dict(linear_solver_type="CGNR", preconditioner_type="SUBSET",
                              residual_blocks_for_subset_preconditioner=[0, 1, 2]))
    with pytest.raises(ValueError, match="one at a time"):
        ctt.solve(opts, _batched(ctt, b), device="cpu")


def test_dynamic_sparsity_needs_sparse_normal_cholesky():
    for lst in ("SPARSE_SCHUR", "DENSE_QR", "CGNR"):
        kw = dict(linear_solver_type=lst, dynamic_sparsity=True)
        ok_ref, _ = _options(ct, kw).is_valid()
        ok, msg = _options(ctt, kw).is_valid()
        assert ok == ok_ref is False and "dynamic_sparsity" in msg
    assert _options(ctt, dict(linear_solver_type="SPARSE_NORMAL_CHOLESKY",
                              dynamic_sparsity=True)).is_valid() == (True, "")


@pytest.mark.parametrize("zero_rhs", [False, True])
def test_conjugate_gradients_host_matches_jax(zero_rhs):
    """The host-preconditioned CG against the JAX function on an SPD system
    with a block-diagonal preconditioner: the same iterations and answer
    (1e-12); a zero right-hand side returns 0 after no iteration in both."""
    from ceres_tpu.solvers.linear.cg import conjugate_gradients_host as jax_cg

    from ceres_tpu_torch.solvers.linear.cg import conjugate_gradients_host

    rng = np.random.default_rng(3)
    n = 40
    M = rng.standard_normal((n, n))
    A = M @ M.T + n * np.diag(rng.uniform(0.5, 2.0, n))
    P = np.linalg.inv(np.diag(np.diag(A)))
    b = np.zeros(n) if zero_rhs else rng.standard_normal(n)
    ref = jax_cg(lambda x: jnp.asarray(A) @ x, b, np.zeros(n), lambda r: P @ np.asarray(r),
                 max_num_iterations=50, q_tolerance=1e-6, r_tolerance=-1.0)
    syncs = []

    def fetch(*scalars):
        syncs.append(len(scalars))
        return [float(v) for v in scalars]

    At, Pt = torch.as_tensor(A), torch.as_tensor(P)
    out = conjugate_gradients_host(lambda x: At @ x, torch.as_tensor(b),
                                   torch.zeros(n, dtype=torch.float64),
                                   lambda r: Pt @ r, fetch=fetch, max_num_iterations=50,
                                   q_tolerance=1e-6, r_tolerance=-1.0)
    assert out.num_iterations == int(ref.num_iterations)
    assert out.termination == int(ref.termination)
    _close(out.x, ref.x)
    assert len(syncs) == max(out.num_iterations, 1)
