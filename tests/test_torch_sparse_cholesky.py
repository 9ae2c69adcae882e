"""The port's native sparse Cholesky (ceres_tpu_torch/native), the twin of
tests/test_sparse_cholesky.py: factor and solve against dense solves on
random SPD matrices, with and without ordering; a refactorization on the
kept symbolic; indefiniteness; the refined float32 factor; the orderings
as valid permutations and their fill. Beyond the twin: the supernodal
factor under relaxed amalgamation against a dense Cholesky (1e-12), on
analyzed patterns and on a supernode structure built so that the update
guard of the JAX copy puts a descendant's rows one place off; the same
orderings and factors as the JAX package's library; and the build key.
Each tolerance is stated where it is used."""
import numpy as np
import pytest
import scipy.sparse as sp

from ceres_tpu_torch import native
from ceres_tpu_torch.native import RefinedSparseCholesky, SparseCholesky, get_lib


def random_spd(n, density_extra=40, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.diags([10.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)], [0, -1, 1]).tolil()
    for _ in range(density_extra):
        i, j = rng.integers(0, n, 2)
        if i != j:
            A[i, j] = A[j, i] = -0.5
    A = A.tocsr()
    A.sort_indices()
    return A


def random_pattern_spd(n, density, seed):
    M = sp.random(n, n, density=density, random_state=seed)
    A = (M + M.T + sp.eye(n) * n).tocsr()
    A.sort_indices()
    return A


@pytest.mark.parametrize("use_ordering", [False, True])
def test_cholesky_solve_matches_dense(use_ordering):
    """A x = b to 1e-10 absolute (|b| ~ 1, A diagonally dominant)."""
    n = 200
    A = random_spd(n, seed=1)
    chol = SparseCholesky(n, A.indptr, A.indices, use_ordering=use_ordering)
    assert chol.factorize(A.data)
    b = np.random.default_rng(2).standard_normal(n)
    np.testing.assert_allclose(A @ chol.solve(b), b, atol=1e-10)


def test_cholesky_refactorize_reuses_symbolic():
    n = 100
    A = random_spd(n, seed=3)
    chol = SparseCholesky(n, A.indptr, A.indices)
    assert chol.factorize(A.data)
    perm, Lp = chol.perm.copy(), chol.Lp.copy()
    A2 = A.copy()
    A2.data = A2.data * 2.0
    assert chol.factorize(A2.data)
    assert np.array_equal(chol.perm, perm) and np.array_equal(chol.Lp, Lp)
    b = np.ones(n)
    np.testing.assert_allclose(A2 @ chol.solve(b), b, atol=1e-10)


@pytest.mark.parametrize("refined", [False, True])
def test_cholesky_detects_indefinite(refined):
    n = 50
    A = random_spd(n, seed=4).tolil()
    A[0, 0] = -1.0
    A = A.tocsr()
    A.sort_indices()
    cls = RefinedSparseCholesky if refined else SparseCholesky
    assert not cls(n, A.indptr, A.indices).factorize(A.data)


def test_rcm_reduces_fill_on_arrow_matrix():
    n = 60
    A = sp.lil_matrix((n, n))
    A[0, :] = 1.0
    A[:, 0] = 1.0
    A.setdiag(10.0)
    A = A.tocsr()
    A.sort_indices()
    natural = SparseCholesky(n, A.indptr, A.indices, use_ordering=False)
    ordered = SparseCholesky(n, A.indptr, A.indices, use_ordering=True)
    assert ordered.nnzL < natural.nnzL


def test_refined_sparse_cholesky_matches_f64():
    """A float32 factor refined three times in float64: A x = b to 1e-10."""
    n = 150
    A = random_spd(n, seed=7)
    r = RefinedSparseCholesky(n, A.indptr, A.indices, max_num_refinement_iterations=3)
    assert r.factorize(A.data)
    b = np.random.default_rng(8).standard_normal(n)
    x = r.solve(b)
    np.testing.assert_allclose(A @ x, b, atol=1e-10)
    ref = SparseCholesky(n, A.indptr, A.indices)
    assert ref.factorize(A.data)
    np.testing.assert_allclose(x, ref.solve(b), atol=1e-12)


def _grid(g):
    n = g * g
    rows, cols, vals = [], [], []
    for i in range(g):
        for j in range(g):
            a = i * g + j
            rows.append(a), cols.append(a), vals.append(4.0)
            for di, dj in ((0, 1), (1, 0), (0, -1), (-1, 0)):
                if 0 <= i + di < g and 0 <= j + dj < g:
                    rows.append(a), cols.append((i + di) * g + j + dj), vals.append(-1.0)
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A.sort_indices()
    return A


def test_mindeg_beats_rcm_on_grid():
    """Minimum degree leaves under 0.7 of RCM's fill on a 24 x 24 grid, and
    SparseCholesky keeps the lower-fill ordering."""
    A = _grid(24)
    n = A.shape[0]
    lib = get_lib()
    ip, ix = A.indptr.astype(np.int64), A.indices.astype(np.int32)
    fills = {}
    for name, fn in (("mindeg", lib.ct_mindeg), ("rcm", lib.ct_rcm)):
        perm = np.zeros(n, np.int32)
        fn(n, ip, ix, perm)
        assert sorted(perm.tolist()) == list(range(n))
        sc = SparseCholesky.__new__(SparseCholesky)
        sc.n, sc._lib = n, lib
        fills[name] = sc._symbolic(lib, perm, ip, ix)[-1]
        lib.ct_super_free(sc._handle)
        sc._handle = None
    assert fills["mindeg"] < 0.7 * fills["rcm"]
    c = SparseCholesky(n, A.indptr, A.indices)
    assert c.nnzL == fills["mindeg"]
    assert c.factorize(A.data)
    np.testing.assert_allclose(A @ c.solve(np.ones(n)), np.ones(n), atol=1e-10)


def test_column_counts_match_full_symbolic():
    lib = get_lib()
    for trial in range(4):
        n = 60 + 40 * trial
        A = random_pattern_spd(n, 0.05 + 0.02 * trial, trial)
        ip, ix = A.indptr.astype(np.int64), A.indices.astype(np.int32)
        cc = np.zeros(n, np.int64)
        nnz_counts = int(lib.ct_chol_counts(n, ip, ix, np.zeros(n, np.int32), cc))
        Lp = np.zeros(n + 1, np.int64)
        nnz_sym = int(lib.ct_chol_symbolic(n, ip, ix, Lp, np.zeros(n, np.int32)))
        assert nnz_counts == nnz_sym
        assert np.array_equal(np.diff(Lp), cc)


def test_nested_dissection_is_valid_permutation_and_factorizes():
    m = 25
    n = m * m
    rows, cols = [], []
    for i in range(m):
        for j in range(m):
            k = i * m + j
            if i + 1 < m and not (i < 3 and j < 3):
                rows += [k, k + m]
                cols += [k + m, k]
            if j + 1 < m and not (i < 3 and j < 3):
                rows += [k, k + 1]
                cols += [k + 1, k]
    A = (sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n)) + sp.eye(n) * 8).tocsr()
    A.sort_indices()
    perm = np.zeros(n, np.int32)
    get_lib().ct_nd(n, A.indptr.astype(np.int64), A.indices.astype(np.int32), perm)
    assert sorted(perm.tolist()) == list(range(n))
    ch = SparseCholesky(n, A.indptr, A.indices)
    assert ch.factorize(A.data)
    b = np.random.default_rng(1).standard_normal(n)
    assert np.linalg.norm(A @ ch.solve(b) - b) <= 1e-10 * np.linalg.norm(b)


# --------------------------------------------------------------------------
# the supernodal factor against a dense Cholesky
# --------------------------------------------------------------------------


def _dense_L(n, Lp, Li, Lx):
    L = np.zeros((n, n))
    for j in range(n):
        L[Li[Lp[j]:Lp[j + 1]], j] += Lx[Lp[j]:Lp[j + 1]]
    return L


def _super_factor(lib, h, A, Lp):
    Li = np.zeros(int(Lp[-1]), np.int32)
    Lx = np.zeros(int(Lp[-1]))
    ret = lib.ct_super_factor(h, A.indptr.astype(np.int64), A.indices.astype(np.int32),
                              A.data.astype(np.float64), Li, Lx)
    return ret, _dense_L(A.shape[0], Lp, Li, Lx)


@pytest.mark.parametrize("relax", [0.2, 0.5, 0.9])
def test_relaxed_amalgamation_factor_matches_dense(relax):
    """The supernodal factor of random patterns in their natural order
    (no fill-reducing ordering: long, ragged update lists) under relaxed
    amalgamation at 20%, 50% and 90% explicit zeros: L within 1e-12 of
    numpy's dense Cholesky, relative to its largest entry. The census of
    each structure counts its updates (ct_super_guard_census) and finds
    none whose two ends line up while its rows do not: on analyzed
    structures every pending row of a descendant is in its target."""
    lib = get_lib()
    total = np.zeros(3, np.int64)
    for seed in range(12):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(40, 160))
        A = random_pattern_spd(n, float(rng.uniform(0.01, 0.08)), seed)
        Lp = np.zeros(n + 1, np.int64)
        h = lib.ct_super_analyze(n, A.indptr.astype(np.int64), A.indices.astype(np.int32),
                                 32, relax, Lp, np.zeros(n, np.int32))
        census = np.zeros(3, np.int64)
        lib.ct_super_guard_census(h, census)
        total += census
        ret, L = _super_factor(lib, h, A, Lp)
        lib.ct_super_free(h)
        ref = np.linalg.cholesky(A.toarray())
        assert ret == 0
        assert np.abs(L - ref).max() <= 1e-12 * np.abs(ref).max()
    assert total[0] > 0 and total[1] > 0 and total[2] == 0


# A supernode structure the analysis never builds: descendant 0's padded
# row 2 is missing from its target, supernode 1, which holds row 4 instead;
# the first and last pending rows (1 and 5) still land on the target's
# first and last rows, so a check of the two ends alone would write row 3's
# update into row 4.
WITNESS_PATTERNS = [[0, 1, 2, 3, 5], [1, 3, 4, 5], [2, 3, 5], [3, 4, 5], [4, 5], [5]]
WITNESS_ENTRIES = [(1, 0, 1.0), (3, 0, 2.0), (5, 0, 1.5), (4, 1, 1.2), (5, 2, 0.7)]


def test_fast_path_guard_on_a_misaligned_descendant():
    """On the witness structure the census finds the one update whose ends
    line up while its rows do not; the port's guard sends it to the
    scatter path and L is within 1e-12 of the dense Cholesky."""
    lib = get_lib()
    n = 6
    A = np.eye(n) * 10
    for i, j, v in WITNESS_ENTRIES:
        A[i, j] = A[j, i] = v
    A = sp.csr_matrix(A)
    A.sort_indices()
    ptr = np.concatenate([[0], np.cumsum([len(p) for p in WITNESS_PATTERNS])]).astype(np.int64)
    Lp = np.zeros(n + 1, np.int64)
    h = lib.ct_super_from_patterns(n, n, np.arange(n + 1, dtype=np.int32), ptr,
                                   np.concatenate(WITNESS_PATTERNS).astype(np.int32), Lp)
    census = np.zeros(3, np.int64)
    lib.ct_super_guard_census(h, census)
    ret, L = _super_factor(lib, h, A, Lp)
    lib.ct_super_free(h)
    assert census[2] == 1
    ref = np.linalg.cholesky(A.toarray())
    assert ret == 0 and np.abs(L - ref).max() <= 1e-12 * np.abs(ref).max()


def test_supernodal_tier_end_to_end():
    """A pattern dense enough for the supernodal tier (30 factor entries a
    column) through SparseCholesky with its ordering: solves to 1e-10, and
    a float32 factor refined to 1e-10."""
    n = 600
    A = random_pattern_spd(n, 0.05, 3)
    chol = SparseCholesky(n, A.indptr, A.indices)
    assert chol.tier == "supernodal"
    before = native.STATS["supernodal"]
    assert chol.factorize(A.data)
    assert native.STATS["supernodal"] == before + 1
    b = np.random.default_rng(4).standard_normal(n)
    assert np.abs(A @ chol.solve(b) - b).max() <= 1e-10 * np.abs(b).max() * n
    r = RefinedSparseCholesky(n, A.indptr, A.indices, max_num_refinement_iterations=3)
    assert r.factorize(A.data)
    assert np.abs(A @ r.solve(b) - b).max() <= 1e-10 * np.abs(b).max() * n


@pytest.mark.parametrize("n,density", [(200, 0.02), (600, 0.05)])
def test_same_ordering_and_factor_as_jax_library(n, density):
    """The same permutation, fill and tier as the JAX package's library,
    and solves within 1e-14 of its (bit for bit in practice): the copy
    changed only the guard, which takes the same path on these patterns."""
    from ceres_tpu.native import SparseCholesky as JaxSparseCholesky

    A = random_pattern_spd(n, density, 1)
    a = SparseCholesky(n, A.indptr, A.indices)
    b = JaxSparseCholesky(n, A.indptr, A.indices)
    assert np.array_equal(a.perm, b.perm) and a.nnzL == b.nnzL and a.use_super == b._use_super
    assert a.factorize(A.data) and b.factorize(A.data)
    rhs = np.random.default_rng(0).standard_normal(n)
    x, y = a.solve(rhs), b.solve(rhs)
    assert np.abs(x - y).max() <= 1e-14 * np.abs(y).max()


def test_build_key_follows_source_flags_compiler_and_isa():
    """The build directory's key changes with the source, the flags, the
    compiler's path or version, and the host's instruction set."""
    base = dict(source=b"src", flags=["-O3", "-march=native"], gxx="/usr/bin/g++",
                version="g++ 12", isa="-mavx2 [enabled]")
    k0 = native.build_key(**base)
    for field, other in (("source", b"src2"), ("flags", ["-O2", "-march=native"]),
                         ("gxx", "/opt/g++"), ("version", "g++ 13"),
                         ("isa", "-mavx2 [disabled]")):
        assert native.build_key(**dict(base, **{field: other})) != k0
    assert native.build_key(**base) == k0
    gxx = native.find_gxx()
    assert "march" in native.host_isa(gxx)
    path = native.build()
    assert path.parent.parent == native.BUILD_ROOT and path.is_file()


def test_no_compiler_raises(monkeypatch):
    """Without g++ the library is not built and nothing falls back."""
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.find_gxx()
