"""The port's preconditioners and Schur options of ITERATIVE_SCHUR
(solvers/linear/preconditioners.py, utils/clustering.py, the explicit S of
sparse_schur.py, bsr_kernels.py and fused_lm.py) against the JAX
package's on the CPU: the twins of tests/test_preconditioners.py; the
clustering, bit for bit; the cluster blocks, the power series apply, the
tridiagonal apply (with an indefinite restriction that takes the
cluster-Jacobi fallback) and the CSR product of S against the JAX
functions; each new option solved in both packages in the host loop and
the fused loop; and the twin of test_misc_components.py's explicit-S
test. Each tolerance is stated where it is used."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ceres_tpu as ct
from ceres_tpu.models import bal as jbal
from ceres_tpu.ops import bsr as jbsr
from ceres_tpu.ops import partition as jpt
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers import bsr_kernels as jbk
from ceres_tpu.solvers.linear import implicit_schur as jis
from ceres_tpu.solvers.linear import preconditioners as jpc
from ceres_tpu.solvers.linear import sparse_schur as jss
from ceres_tpu.types import VisibilityClusteringType as JaxClustering
from ceres_tpu.utils import clustering as jcl
from ceres_tpu.utils import ordering as jordering

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.ops import bsr
from ceres_tpu_torch.ops import flatops as fo
from ceres_tpu_torch.ops import partition as pt
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.solvers.linear import implicit_schur as tis
from ceres_tpu_torch.solvers.linear import preconditioners as tpc
from ceres_tpu_torch.solvers.linear import sparse_schur as tss
from ceres_tpu_torch.utils import clustering as tcl
from ceres_tpu_torch.utils import ordering
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

PT = ctt.PreconditionerType
TYPES = ["CANONICAL_VIEWS", "SINGLE_LINKAGE"]


class Setup:
    """One BAL problem in both packages at its initial state: the JAX
    partition and block values, the port's partition, flat ops and the
    same values flattened, and the residuals."""

    def __init__(self, nc, npts, seed):
        b = jbal.perturb(jbal.synthetic_bal(num_cameras=nc, num_points=npts, visibility=0.5,
                                            noise=0.05, seed=seed), 0.01, 0.05, 0.05,
                         seed=seed + 1)
        jprog = JaxProgram(jbal.build_problem_batched(b)[0], sort_rows=True)
        o = jprog._eval_core(jprog.initial_state(), True, False)
        self.jvalues, self.res = o["block_jacs"], np.asarray(o["residuals"])
        self.jpm = jpt.build_partition(jbsr.build_meta(jprog), jordering.eligible_e_sets(jprog))
        prog = CompiledProgram(tbal.build_problem_batched(tbal.from_arrays(
            b.cameras.copy(), b.points.copy(), b.camera_index, b.point_index,
            b.observations))[0], device="cpu")
        self.pm = pt.build_partition(bsr.build_meta(prog), ordering.eligible_e_sets(prog))
        self.flat = fo.FlatSchurOps(self.pm, prog)
        self.vflat = fo._FlatOpsBase.flatten([[torch.as_tensor(np.array(V)) for V in slots]
                                             for slots in self.jvalues])
        self.values = [[torch.as_tensor(np.array(V)) for V in slots] for slots in self.jvalues]
        self.num_f = sum(nv for (_, nv, _, _) in self.pm.f_fams)
        self.D = np.random.default_rng(seed).uniform(0.5, 1.5, self.pm.base.tangent_size)

    def d_parts(self):
        """(JAX D_e, D_f; the port's)."""
        jD, tD = jnp.asarray(self.D), torch.as_tensor(self.D)
        return (jpt.extract_e(self.jpm, jD), jpt.extract_f(self.jpm, jD),
                pt.extract_e(self.pm, tD), pt.extract_f(self.pm, tD))


_SETUPS = {}


def setup(nc):
    """The 6-camera (40 points, seed 2) and 8-camera (60 points, seed 0)
    problems of tests/test_preconditioners.py."""
    if nc not in _SETUPS:
        _SETUPS[nc] = Setup(nc, {6: 40, 8: 60}[nc], {6: 2, 8: 0}[nc])
    return _SETUPS[nc]


def _close(out, ref, tol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1.0)


def _chain_structures(s, forest=((0, 1), (1, 2), (2, 3))):
    """Four clusters (camera i in cluster i % 4), with the forest given
    (None: CLUSTER_JACOBI), in both packages."""
    membership = np.arange(s.num_f) % 4
    forest = None if forest is None else list(forest)
    return (jpc.ClusterStructure(s.jpm, membership, forest),
            tpc.ClusterStructure(s.pm, membership, forest))


# -- the twins of tests/test_preconditioners.py --------------------------------


def _dense_restricted_schur(s, D, cs):
    """The port's dense damped S restricted to the camera pairs within a
    cluster and along the chain edges (what CLUSTER_TRIDIAGONAL inverts)."""
    tD = torch.as_tensor(D)
    D_e, D_f = pt.extract_e(s.pm, tD), pt.extract_f(s.pm, tD)
    sys = tis.build_schur_system(s.pm, s.values, torch.as_tensor(s.res), D_e, s.flat)
    n = s.pm.f_size
    S = np.column_stack([tis.schur_multiply(s.pm, s.values, sys, D_f,
                                            torch.eye(n, dtype=torch.float64)[:, j]).numpy()
                         for j in range(n)])
    loc = cs.loc_cluster[:n]
    allowed = loc[:, None] == loc[None, :]
    for c in range(len(cs.cluster_indices)):
        pa = cs.parent_of[c] if cs.chains is not None else -1
        if pa >= 0:
            a = loc[:, None] == c
            b = loc[None, :] == pa
            allowed |= (a & b) | (a & b).T
    return np.where(allowed, S, 0.0)


def test_cluster_tridiagonal_exact_solve():
    """apply(v) == solve(restricted S, v) for a 4-cluster chain, 1e-8."""
    s = setup(8)
    _, cs = _chain_structures(s)
    assert cs.chains is not None and len(cs.chains) == 1
    asm = tpc.ClusterBlockAssembler(s.pm, cs, s.flat)
    D = np.ones(s.pm.base.tangent_size)
    tD = torch.as_tensor(D)
    precond = tpc.make_cluster_tridiagonal_preconditioner(
        cs, lambda: asm(s.vflat, pt.extract_e(s.pm, tD), pt.extract_f(s.pm, tD)))
    v = np.random.default_rng(0).standard_normal(s.pm.f_size)
    np.testing.assert_allclose(precond(torch.as_tensor(v)).numpy(),
                               np.linalg.solve(_dense_restricted_schur(s, D, cs), v), rtol=1e-8)


def test_cluster_tridiagonal_empty_forest_matches_jacobi():
    """No forest edges: the tridiagonal apply is the cluster-Jacobi one,
    1e-9."""
    s = setup(6)
    membership = np.arange(s.num_f) % 3
    tD = torch.ones(s.pm.base.tangent_size, dtype=torch.float64)
    D_e, D_f = pt.extract_e(s.pm, tD), pt.extract_f(s.pm, tD)
    cs_t = tpc.ClusterStructure(s.pm, membership, [])
    asm_t = tpc.ClusterBlockAssembler(s.pm, cs_t, s.flat)
    tri = tpc.make_cluster_tridiagonal_preconditioner(cs_t, lambda: asm_t(s.vflat, D_e, D_f))
    cs_j = tpc.ClusterStructure(s.pm, membership, None)
    asm_j = tpc.ClusterBlockAssembler(s.pm, cs_j, s.flat)
    jac = tpc.make_cluster_preconditioner(cs_j, lambda: asm_j(s.vflat, D_e, D_f))
    v = torch.as_tensor(np.random.default_rng(1).standard_normal(s.pm.f_size))
    np.testing.assert_allclose(tri(v).numpy(), jac(v).numpy(), rtol=1e-9)


def _precond_problem():
    b = tbal.synthetic_bal(num_cameras=6, num_points=50, visibility=0.5, noise=0.1, seed=7)
    return tbal.build_problem_batched(tbal.perturb(b, 0.01, 0.05, 0.05, seed=8))[0]


@pytest.mark.parametrize("precond", ["JACOBI", "SCHUR_JACOBI", "SCHUR_POWER_SERIES_EXPANSION",
                                     "CLUSTER_JACOBI", "CLUSTER_TRIDIAGONAL"])
def test_iterative_schur_preconditioner_matrix(precond):
    """Every preconditioner reaches the DENSE_SCHUR final cost (x 1.05)."""
    ref = ctt.solve(ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                                max_num_iterations=25), _precond_problem(), device="cpu")
    s = ctt.solve(ctt.Options(linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR,
                              preconditioner_type=PT.parse(precond), max_num_iterations=25,
                              eta=1e-4), _precond_problem(), device="cpu")
    assert s.is_solution_usable()
    assert s.final_cost < ref.final_cost * 1.05 + 1e-10


# -- the clustering ----------------------------------------------------------


def _random_graph(n=40, seed=3):
    """A seeded random visibility graph: weights in (0, 1), a fifth of them
    at 0.9 or more (single linkage merges those)."""
    rng = np.random.default_rng(seed)
    edges = {}
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < 0.15:
                edges[(i, j)] = float(rng.uniform(0.9, 1.0) if rng.random() < 0.2
                                      else rng.uniform(0.0, 0.9))
    return n, edges


@pytest.mark.parametrize("graph", ["bal6", "bal8", "random", "c2048"])
@pytest.mark.parametrize("kind", TYPES)
def test_clustering_matches_jax_bit_for_bit(graph, kind):
    """The visibility graph (edges, weights and their order), the
    membership, the degree-2 forest and its edge order equal the JAX
    functions' exactly; "c2048" is chip_smoke.py's 2,048-camera instance
    (13 canonical views)."""
    if graph == "random":
        n, edges = _random_graph()
    elif graph == "c2048":
        b = jbal.synthetic_bal_large(num_cameras=2048, num_points=30_000, mean_track=4.4,
                                     cam_window=60, seed=0)
        n = b.num_cameras
        edges = jcl.compute_visibility_graph(b.point_index, b.camera_index, n)
    else:
        b = jbal.synthetic_bal(num_cameras=int(graph[3:]), num_points=60, visibility=0.5,
                               seed=int(graph[3:]))
        n = b.num_cameras
        edges = jcl.compute_visibility_graph(b.point_index, b.camera_index, n)
        t_edges = tcl.compute_visibility_graph(b.point_index, b.camera_index, n)
        assert list(t_edges.items()) == list(edges.items())
    fn = "single_linkage_clustering" if kind == "SINGLE_LINKAGE" else "canonical_views_clustering"
    jm, tm = getattr(jcl, fn)(n, edges), getattr(tcl, fn)(n, edges)
    assert np.array_equal(tm, jm) and tm.dtype == jm.dtype
    assert (tcl.maximum_spanning_forest_degree2(n, edges, tm)
            == jcl.maximum_spanning_forest_degree2(n, edges, jm))


@pytest.mark.parametrize("nc", [6, 8])
@pytest.mark.parametrize("kind", TYPES)
def test_cluster_structure_matches_jax(nc, kind):
    """The host loop's clustering of a problem (the JAX _build_cluster,
    CLUSTER_TRIDIAGONAL): the same membership, cluster tangent indices,
    chains in the same order, parents and padded gather table."""
    s = setup(nc)
    jcs, _ = jbk._build_cluster(
        s.jpm, ct.Options(visibility_clustering_type=JaxClustering[kind]), tridiagonal=True)
    tcs, _ = tpc.build_cluster(s.pm, s.flat, ctt.VisibilityClusteringType[kind], True)
    assert np.array_equal(tcs.membership, jcs.membership)
    assert [list(c) for c in tcs.chains] == [list(c) for c in jcs.chains]
    assert np.array_equal(tcs.parent_of, jcs.parent_of)
    assert np.array_equal(tcs.gather, jcs.gather) and np.array_equal(tcs.mask, jcs.mask)
    assert all(np.array_equal(a, b) for a, b in zip(tcs.cluster_indices, jcs.cluster_indices))


# -- the blocks and the applies ------------------------------------------------


@pytest.mark.parametrize("tridiagonal", [False, True])
def test_cluster_blocks_match_jax(tridiagonal):
    """ClusterBlockAssembler's (C, m, m) blocks (and the chain-parent
    blocks) within 1e-12 of the JAX assembler's, and a second assembly bit
    for bit the first (no atomics)."""
    s = setup(8)
    jcs, tcs = _chain_structures(s, ((0, 1), (1, 2), (2, 3)) if tridiagonal else None)
    jD_e, jD_f, tD_e, tD_f = s.d_parts()
    ref = jpc.ClusterBlockAssembler(s.jpm, jcs)(s.jvalues, jD_e, jD_f)
    asm = tpc.ClusterBlockAssembler(s.pm, tcs, s.flat)
    out = asm(s.vflat, tD_e, tD_f)
    again = asm(s.vflat, tD_e, tD_f)
    for o, r, a in zip(*((x,) if not tridiagonal else x for x in (out, ref, again))):
        _close(o, r, 1e-12)
        assert torch.equal(o, a)


def test_spse_apply_matches_jax():
    """The power series apply (5 terms over SCHUR_JACOBI and the implicit S)
    within 1e-12 of the JAX make_spse_preconditioner's."""
    s = setup(8)
    jD_e, jD_f, tD_e, tD_f = s.d_parts()
    jsys = jis.build_schur_system(s.jpm, s.jvalues, jnp.asarray(s.res), jD_e)
    tsys = tis.build_schur_system(s.pm, s.values, torch.as_tensor(s.res), tD_e, s.flat)
    v = np.random.default_rng(2).standard_normal(s.pm.f_size)
    ref = jpc.make_spse_preconditioner(s.jpm, s.jvalues, jsys, jD_f, 5)(jnp.asarray(v))
    out = tpc.make_spse_preconditioner(s.pm, s.values, tsys, tD_f, 5)(torch.as_tensor(v))
    _close(out, ref, 1e-12)


@pytest.mark.parametrize("case", ["restricted", "indefinite"])
def test_tridiagonal_apply_matches_jax(case):
    """The CLUSTER_TRIDIAGONAL apply on the same blocks within 1e-10 of the
    JAX one. "indefinite": the chain blocks scaled by 10 make the
    tridiagonal restriction indefinite; both packages then apply the
    cluster-Jacobi factors (checked against the cluster-Jacobi apply)."""
    s = setup(8)
    jcs, tcs = _chain_structures(s)
    jD_e, jD_f, _, _ = s.d_parts()
    D, O = (np.asarray(x) for x in jpc.ClusterBlockAssembler(s.jpm, jcs)(s.jvalues, jD_e, jD_f))
    if case == "indefinite":
        O = 10.0 * O
        R = np.zeros((4 * tcs.max_dim,) * 2)
        m = tcs.max_dim
        for c in range(4):
            R[c * m:(c + 1) * m, c * m:(c + 1) * m] = D[c]
            if tcs.parent_of[c] >= 0:
                p = tcs.parent_of[c]
                R[c * m:(c + 1) * m, p * m:(p + 1) * m] = O[c]
                R[p * m:(p + 1) * m, c * m:(c + 1) * m] = O[c].T
        assert np.linalg.eigvalsh(R).min() < 0
    v = np.random.default_rng(4).standard_normal(s.pm.f_size)
    ref = jpc.make_cluster_tridiagonal_preconditioner(
        jcs, lambda: (jnp.asarray(D), jnp.asarray(O)))(jnp.asarray(v))
    out = tpc.make_cluster_tridiagonal_preconditioner(
        tcs, lambda: (torch.as_tensor(D), torch.as_tensor(O)))(torch.as_tensor(v))
    _close(out, ref, 1e-10)
    if case == "indefinite":
        jac = tpc.make_cluster_preconditioner(tcs, lambda: torch.as_tensor(D))
        _close(out, jac(torch.as_tensor(v)), 1e-12)


def test_csr_matvec_matches_jax():
    """S z by the CSR product (kernels 7 and 6) over each package's own S
    values within 1e-12 of the JAX csr_matvec_fn, and bit for bit on a
    repeat."""
    s = setup(8)
    jD_e, jD_f, tD_e, tD_f = s.d_parts()
    ref_s = jss.SparseSchurSolver(s.jpm)
    sss = tss.SparseSchurSolver(s.pm, s.flat)
    assert np.array_equal(sss.indptr, ref_s.indptr) and np.array_equal(sss.indices,
                                                                        ref_s.indices)
    tsys = tis.build_schur_system(s.pm, s.values, torch.as_tensor(s.res), tD_e, s.flat)
    svals = sss.values(s.vflat, tsys.minv, tD_f)
    z = np.random.default_rng(6).standard_normal(s.pm.f_size)
    ref = ref_s.csr_matvec_fn()(ref_s._numeric_impl(s.jvalues, jD_e, jD_f), jnp.asarray(z))
    mv = sss.csr_matvec_fn()
    out = mv(svals, torch.as_tensor(z))
    _close(out, ref, 1e-12)
    assert torch.equal(out, mv(svals, torch.as_tensor(z)))


# -- solves in both packages ---------------------------------------------------

# the option sets that raised naming slice 6 before this port, and single
# linkage: (options, tolerance on the final cost, CG counts compared)
OPTION_SETS = {
    # the power series' CG counts follow rounding: the JAX package's own two
    # loops part at row 3 (23 and 20 CG iterations); final cost 1e-8
    "spse": (dict(preconditioner_type="SCHUR_POWER_SERIES_EXPANSION"), 1e-8, False),
    "spse_init": (dict(use_spse_initialization=True), 1e-10, True),
    "cluster_jacobi": (dict(preconditioner_type="CLUSTER_JACOBI"), 1e-10, True),
    "cluster_jacobi_single_linkage": (dict(preconditioner_type="CLUSTER_JACOBI",
                                           visibility_clustering_type="SINGLE_LINKAGE"),
                                      1e-10, True),
    "cluster_tridiagonal": (dict(preconditioner_type="CLUSTER_TRIDIAGONAL"), 1e-10, True),
    "explicit_schur": (dict(use_explicit_schur_complement=True), 1e-10, True),
    # runs as IDENTITY in both packages' host loops (the fused one refuses
    # it); IDENTITY CGNR's counts follow rounding
    "cgnr_cluster_jacobi": (dict(linear_solver_type="CGNR",
                                 preconditioner_type="CLUSTER_JACOBI"), 1e-10, False),
}


def _options(pkg, kw, loop):
    kw = dict(kw)
    types = ct.types if pkg is ct else ctt.types
    out = dict(linear_solver_type=pkg.LinearSolverType.parse(
        kw.pop("linear_solver_type", "ITERATIVE_SCHUR")), max_num_iterations=25, eta=1e-4,
        fused_loop=loop)
    for name, enum in (("preconditioner_type", types.PreconditionerType),
                       ("visibility_clustering_type", types.VisibilityClusteringType)):
        if name in kw:
            out[name] = enum.parse(kw.pop(name))
    return pkg.Options(**out, **kw)


@pytest.mark.parametrize("loop", ["NEVER", "ALWAYS"])
@pytest.mark.parametrize("name", list(OPTION_SETS))
def test_new_options_match_jax(name, loop):
    """Each option on test_preconditioners.py's 6-camera problem in both
    packages, in the host loop ("NEVER") and the fused loop ("ALWAYS"):
    the same termination and rows (count and accepted steps), the final
    cost within the stated tolerance, and the same CG counts where they
    do not follow rounding."""
    kw, tol, counts = OPTION_SETS[name]
    b = jbal.perturb(jbal.synthetic_bal(num_cameras=6, num_points=50, visibility=0.5,
                                        noise=0.1, seed=7), 0.01, 0.05, 0.05, seed=8)
    # each solve writes its answer into the arrays it was built on
    tp = tbal.build_problem_batched(tbal.from_arrays(
        b.cameras.copy(), b.points.copy(), b.camera_index, b.point_index, b.observations))[0]
    js = ct.solve(_options(ct, kw, loop), jbal.build_problem_batched(b)[0])
    ts = ctt.solve(_options(ctt, kw, loop), tp, device="cpu")
    assert ts.termination_type.name == js.termination_type.name
    assert [r.step_is_successful for r in ts.iterations] == [
        r.step_is_successful for r in js.iterations]
    assert abs(ts.final_cost - js.final_cost) <= tol * js.final_cost
    if counts:
        assert [r.linear_solver_iterations for r in ts.iterations] == [
            r.linear_solver_iterations for r in js.iterations]


def test_explicit_schur_complement_matches_reference():
    """The twin of test_misc_components.py's: ITERATIVE_SCHUR with the
    explicit S on a problem built per block reaches DENSE_SCHUR's final
    cost (1e-4 relative), and the JAX package's explicit S (1e-10)."""
    def make(pkg_bal, pkg):
        b = jbal.perturb(jbal.synthetic_bal(num_cameras=6, num_points=50, visibility=0.6,
                                            noise=0.05, seed=3), 0.01, 0.05, 0.05, seed=2)
        if pkg is ct:
            return jbal.build_problem(b)[0]
        return tbal.build_problem(tbal.from_arrays(
            b.cameras, b.points, b.camera_index, b.point_index, b.observations))[0]

    ref = ctt.solve(ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                                max_num_iterations=60), make(tbal, ctt), device="cpu")
    s = ctt.solve(ctt.Options(linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR,
                              use_explicit_schur_complement=True, max_num_iterations=100),
                  make(tbal, ctt), device="cpu")
    js = ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType.ITERATIVE_SCHUR,
                             use_explicit_schur_complement=True, max_num_iterations=100),
                  make(jbal, ct))
    assert s.is_solution_usable()
    assert abs(s.final_cost - ref.final_cost) <= 1e-4 * max(1.0, ref.final_cost)
    assert abs(s.final_cost - js.final_cost) <= 1e-10 * js.final_cost
