"""The host sparse Cholesky of the sparse direct solvers and the sparse QR
of the covariance (counterpart of ceres_tpu/native/__init__.py):
`sparse_cholesky.cc`, the port's own copy of the JAX package's source with
the supernodal fast-path guard repaired, and `sparse_qr.cc`, its copy of
the George-Heath row-Givens QR; each built with g++ at first use and bound
through ctypes.

Each library lands in `build/native/<key>/` at the root of the checkout
(git-ignored). The key hashes the source, the compile flags, the
compiler's path and version, and the host's instruction set as g++ sees it
(`-march=native -Q --help=target`): `-march=native` code built on one host
is never loaded on another. The build writes a temporary directory and
renames it into place, so processes that build at once (test workers)
never load a half-written library. Without g++ it raises; there is no
other factorization to fall back to.

`SparseCholesky` analyzes a symmetric CSR pattern once (supervariable
compression, minimum-degree, nested-dissection and RCM candidates ranked
by column counts, an elimination-tree postorder, and the simplicial or
supernodal tier by the factor's density) and refactors new values on it;
`RefinedSparseCholesky` factors in float32 and refines the solve in
float64; `solve_multi` solves many right-hand sides in one call.
`STATS` counts the factorizations and solves, their host seconds, the
tier each factorization took and the bytes the sparse solvers brought
from the device; `reset_stats()` zeroes it. `SparseQR` holds R of a CSR
matrix in the QR library's global state, one live factor at a time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
SRC = _DIR / "sparse_cholesky.cc"
BUILD_ROOT = _DIR.parent.parent / "build" / "native"
LIB_NAME = "libct_sparse_cholesky.so"
SRC_QR = _DIR / "sparse_qr.cc"
QR_LIB_NAME = "libct_sparse_qr.so"
FLAGS = ["-O3", "-march=native", "-funroll-loops", "-fPIC", "-shared", "-std=c++17"]

STATS = {}


def reset_stats() -> None:
    STATS.update(factorizations=0, factor_s=0.0, solves=0, solve_s=0.0,
                 supernodal=0, simplicial=0, dtoh_bytes=0)


reset_stats()

_lib = None


def find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the sparse Cholesky of the sparse "
                           "solvers builds with g++")
    return gxx


def _run(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout


def host_isa(gxx: str) -> str:
    """The instruction set -march=native selects on this host, as g++
    reports it."""
    return _run([gxx, "-march=native", "-Q", "--help=target"])


def build_key(source: bytes, flags, gxx: str, version: str, isa: str) -> str:
    h = hashlib.sha256()
    for part in (source, " ".join(flags).encode(), gxx.encode(), version.encode(),
                 isa.encode()):
        h.update(hashlib.sha256(part).digest())
    return h.hexdigest()[:20]


def library_key(src: pathlib.Path, flags=FLAGS, source: bytes = None) -> str:
    """The build directory's key of a library from `src` (its bytes, or
    `source` in their place) built with `flags` by this host's g++."""
    gxx = find_gxx()
    return build_key(src.read_bytes() if source is None else source, flags, gxx,
                     _run([gxx, "--version"]), host_isa(gxx))


def build(src: pathlib.Path = SRC, lib_name: str = LIB_NAME, flags=FLAGS) -> pathlib.Path:
    """The library's path, built unless an identical build exists."""
    gxx = find_gxx()
    key = library_key(src, flags)
    out_dir = BUILD_ROOT / key
    lib = out_dir / lib_name
    if lib.is_file():
        return lib
    tmp = BUILD_ROOT / f"{key}.tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    try:
        res = subprocess.run([gxx, *flags, str(src), "-o", str(tmp / lib_name)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {src.name}:\n{res.stderr}")
        tmp.rename(out_dir)
    except OSError:  # another process finished the same build first
        if not lib.is_file():
            raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32, i64, dbl, ptr = ctypes.c_int32, ctypes.c_int64, ctypes.c_double, ctypes.c_void_p
    sigs = {
        "ct_rcm": (i32, [i32, i64p, i32p, i32p]),
        "ct_mindeg": (i32, [i32, i64p, i32p, i32p]),
        "ct_nd": (i32, [i32, i64p, i32p, i32p]),
        "ct_chol_counts": (i64, [i32, i64p, i32p, i32p, i64p]),
        "ct_chol_symbolic": (i64, [i32, i64p, i32p, i64p, i32p]),
        "ct_permute_pattern": (i32, [i32, i64p, i32p, i32p, i64p, i32p, i64p]),
        "ct_compress": (i32, [i32, i64p, i32p, i32p, i64p, i32p]),
        "ct_chol_numeric": (i32, [i32, i64p, i32p, f64p, i64p, i32p, i32p, f64p]),
        "ct_chol_numeric_f32": (i32, [i32, i64p, i32p, f64p, i64p, i32p, i32p, f32p]),
        "ct_etree_postorder": (i32, [i32, i64p, i32p, i32p]),
        "ct_super_analyze": (ptr, [i32, i64p, i32p, i32, dbl, i64p, i32p]),
        "ct_super_free": (None, [ptr]),
        "ct_super_factor": (i32, [ptr, i64p, i32p, f64p, i32p, f64p]),
        "ct_super_factor_f32": (i32, [ptr, i64p, i32p, f64p, i32p, f32p]),
        "ct_chol_solve": (i32, [i32, i64p, i32p, f64p, f64p]),
        "ct_chol_solve_f32": (i32, [i32, i64p, i32p, f32p, f64p]),
        "ct_chol_solve_multi": (i32, [i32, i32, i64p, i32p, f64p, f64p]),
        "ct_csr_matvec": (i32, [i32, i64p, i32p, f64p, f64p, f64p]),
        "ct_super_from_patterns": (ptr, [i32, i32, i32p, i64p, i32p, i64p]),
        "ct_super_guard_census": (None, [ptr, i64p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    _lib = lib
    return lib


class SparseCholesky:
    """Cached-symbolic sparse Cholesky (sparse_cholesky.h:73-112:
    Factorize with the symbolic reused, then Solve) of a full symmetric
    CSR pattern: the orderings are analyzed once and the one of least fill
    kept; each factorization reuses the analysis."""

    def __init__(self, n, indptr, indices, use_ordering: bool = True):
        lib = get_lib()
        self._lib = lib
        self.n = int(n)
        indptr = np.ascontiguousarray(indptr, np.int64)
        indices = np.ascontiguousarray(indices, np.int32)
        perm = (self._ordering(lib, indptr, indices) if use_ordering and self.n > 1
                else np.arange(self.n, dtype=np.int32))
        (self.perm, self.iperm, self.pindptr, self.pindices, self.value_perm,
         self.Lp, self.parent, self.nnzL) = self._symbolic(lib, perm, indptr, indices)
        self.Li = np.zeros(self.nnzL, np.int32)
        self.Lx = np.zeros(self.nnzL, np.float64)

    def _ordering(self, lib, indptr, indices):
        """The fill-reducing permutation: columns of identical closed
        adjacency compressed into one quotient node (a hash collision only
        merges more nodes, which can cost fill but never correctness: the
        symbolic runs on the true pattern), the candidates ordered on the
        quotient graph and ranked by its column counts weighted by node
        size, the winner expanded to scalar columns."""
        gof, qptr, qidx, gsize = _compress_supervariables(self.n, indptr, indices)
        nq = int(gsize.shape[0])
        if nq > 0.85 * self.n:  # not worth compressing: order the graph itself
            gof = np.arange(self.n, dtype=np.int32)
            qptr, qidx = indptr, indices
            gsize = np.ones(self.n, np.int64)
            nq = self.n
        fns = [lib.ct_mindeg]
        if nq > 1000:
            fns.append(lib.ct_nd)  # wins on grid-like patterns
        if nq <= 50_000:
            fns.append(lib.ct_rcm)  # covers minimum degree's pathologies
        best, best_score = None, None
        for fn in fns:
            bperm = np.zeros(nq, np.int32)
            fn(nq, qptr, qidx, bperm)
            if len(fns) == 1:
                best = bperm
                break
            biperm = np.argsort(bperm).astype(np.int32)
            qnnz = qidx.shape[0]
            bp, bi = np.zeros(nq + 1, np.int64), np.zeros(qnnz, np.int32)
            lib.ct_permute_pattern(nq, qptr, qidx, biperm, bp, bi, np.zeros(qnnz, np.int64))
            cc = np.zeros(nq, np.int64)
            lib.ct_chol_counts(nq, bp, bi, np.zeros(nq, np.int32), cc)
            score = int(np.sum(cc * gsize[bperm].astype(np.int64)))
            if best is None or score < best_score:
                best, best_score = bperm, score
        return _expand_ordering(gof, best)

    def _permuted_pattern(self, lib, perm, indptr, indices):
        """(pindptr, pindices, value_perm) of A'[iperm[i], iperm[j]] = A[i, j]."""
        iperm = np.argsort(perm).astype(np.int32)
        nnz = indices.shape[0]
        pindptr = np.zeros(self.n + 1, np.int64)
        pindices = np.zeros(nnz, np.int32)
        value_perm = np.zeros(nnz, np.int64)
        lib.ct_permute_pattern(self.n, indptr, indices, iperm, pindptr, pindices,
                               value_perm)
        return pindptr, pindices, value_perm

    def _symbolic(self, lib, perm, indptr, indices):
        """The ordering composed with an elimination-tree postorder (fill
        unchanged, subtrees contiguous for the supernodes), then the
        supernodal analysis. The tier: supernodal (relaxed amalgamation,
        20% explicit zeros at most) where the factor holds at least 30
        entries a column, else simplicial (relax 0, Lp unpadded). Lp is
        the padded column pointer every solve kernel reads."""
        pindptr, pindices, _ = self._permuted_pattern(lib, perm, indptr, indices)
        post = np.zeros(self.n, np.int32)
        if lib.ct_etree_postorder(self.n, pindptr, pindices, post) == 0:
            perm = perm[post]
        iperm = np.argsort(perm).astype(np.int32)
        pindptr, pindices, value_perm = self._permuted_pattern(lib, perm, indptr, indices)
        Lp = np.zeros(self.n + 1, np.int64)
        parent = np.zeros(self.n, np.int32)
        cc = np.zeros(self.n, np.int64)
        lib.ct_chol_counts(self.n, pindptr, pindices, parent, cc)
        self.use_super = float(cc.sum()) / max(self.n, 1) >= 30.0
        self._handle = lib.ct_super_analyze(self.n, pindptr, pindices, 32,
                                            0.2 if self.use_super else 0.0, Lp, parent)
        return (perm, iperm, pindptr, pindices, value_perm, Lp, parent, int(Lp[self.n]))

    @property
    def tier(self) -> str:
        return "supernodal" if self.use_super else "simplicial"

    def __del__(self):
        h = getattr(self, "_handle", None)
        if h:
            self._lib.ct_super_free(h)
            self._handle = None

    def _factor(self, pv, Lx, f32: bool) -> bool:
        t0 = time.perf_counter()
        if self.use_super:
            fn = self._lib.ct_super_factor_f32 if f32 else self._lib.ct_super_factor
            ret = fn(self._handle, self.pindptr, self.pindices, pv, self.Li, Lx)
        else:
            fn = self._lib.ct_chol_numeric_f32 if f32 else self._lib.ct_chol_numeric
            ret = fn(self.n, self.pindptr, self.pindices, pv, self.Lp, self.parent,
                     self.Li, Lx)
        STATS["factorizations"] += 1
        STATS["factor_s"] += time.perf_counter() - t0
        STATS[self.tier] += 1
        return ret == 0

    def factorize(self, values) -> bool:
        """Numeric factorization; False where the matrix is not positive
        definite."""
        pv = np.ascontiguousarray(np.asarray(values, np.float64)[self.value_perm])
        return self._factor(pv, self.Lx, False)

    def solve(self, b) -> np.ndarray:
        t0 = time.perf_counter()
        x = np.ascontiguousarray(np.asarray(b, np.float64)[self.perm])
        self._lib.ct_chol_solve(self.n, self.Lp, self.Li, self.Lx, x)
        STATS["solves"] += 1
        STATS["solve_s"] += time.perf_counter() - t0
        return x[self.iperm]

    def solve_multi(self, B) -> np.ndarray:
        """Solves for the columns of B (n, m) in one call."""
        t0 = time.perf_counter()
        B = np.asarray(B, np.float64)
        m = B.shape[1]
        flat = np.ascontiguousarray(B[self.perm, :].T).reshape(-1)
        self._lib.ct_chol_solve_multi(self.n, m, self.Lp, self.Li, self.Lx, flat)
        STATS["solves"] += m
        STATS["solve_s"] += time.perf_counter() - t0
        return flat.reshape(m, self.n).T[self.iperm, :]


class RefinedSparseCholesky:
    """Mixed-precision sparse direct solve: a float32 factorization and
    float64 iterative refinement (the reference's RefinedSparseCholesky +
    SparseIterativeRefiner, iterative_refiner.h:61-94)."""

    def __init__(self, n, indptr, indices, max_num_refinement_iterations: int = 3,
                 use_ordering: bool = True):
        self.base = SparseCholesky(n, indptr, indices, use_ordering)
        self.max_iters = max_num_refinement_iterations
        self.Lx32 = np.zeros(self.base.nnzL, np.float32)
        self._pvals = None

    @property
    def tier(self) -> str:
        return self.base.tier

    def factorize(self, values) -> bool:
        b = self.base
        self._pvals = np.ascontiguousarray(np.asarray(values, np.float64)[b.value_perm])
        return b._factor(self._pvals, self.Lx32, True)

    def solve(self, rhs) -> np.ndarray:
        t0 = time.perf_counter()
        b = self.base
        bp = np.ascontiguousarray(np.asarray(rhs, np.float64)[b.perm])
        x = bp.copy()
        b._lib.ct_chol_solve_f32(b.n, b.Lp, b.Li, self.Lx32, x)
        tmp = np.zeros_like(x)
        for _ in range(self.max_iters):
            b._lib.ct_csr_matvec(b.n, b.pindptr, b.pindices, self._pvals, x, tmp)
            corr = bp - tmp
            b._lib.ct_chol_solve_f32(b.n, b.Lp, b.Li, self.Lx32, corr)
            x = x + corr
        STATS["solves"] += 1
        STATS["solve_s"] += time.perf_counter() - t0
        return x[b.iperm]


def minimum_degree_ordering(n, indptr, indices) -> np.ndarray:
    """The minimum-degree permutation (new -> old) of a symmetric pattern
    with its diagonal: ordered on the quotient graph of its supervariables
    (a block's columns, which share their adjacency, are one node) and
    expanded to columns, each group's in its own order. Ordering the
    columns themselves costs a dense column's degree at every elimination:
    minutes at BAL-16's 66k columns."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    gof, qptr, qidx, _ = _compress_supervariables(n, indptr, indices)
    bperm = np.zeros(int(qptr.shape[0]) - 1, np.int32)
    get_lib().ct_mindeg(bperm.shape[0], qptr, qidx, bperm)
    return _expand_ordering(gof, bperm)


def _expand_ordering(gof, bperm) -> np.ndarray:
    """The column permutation (new -> old) of a quotient-graph ordering
    bperm: each group's columns together, in their own order."""
    block_pos = np.zeros(bperm.shape[0], np.int64)
    block_pos[bperm] = np.arange(bperm.shape[0])
    return np.lexsort((np.arange(gof.shape[0]), block_pos[gof])).astype(np.int32)


def _compress_supervariables(n, indptr, indices):
    """Columns of identical closed adjacency grouped (ct_compress) and the
    quotient graph: (group of each column (n,), qptr, qidx, group sizes)."""
    lib = get_lib()
    gof = np.zeros(n, np.int32)
    qptr_full = np.zeros(n + 1, np.int64)
    qidx_full = np.zeros(max(indices.shape[0], 1), np.int32)
    nq = int(lib.ct_compress(n, indptr, indices, gof, qptr_full, qidx_full))
    qptr = np.ascontiguousarray(qptr_full[:nq + 1])
    qidx = np.ascontiguousarray(qidx_full[:int(qptr[nq])])
    return gof, qptr, qidx, np.bincount(gof, minlength=nq).astype(np.int64)


_qr_lib = None


def get_qr_lib():
    """The sparse QR library (sparse_qr.cc), built like the Cholesky's."""
    global _qr_lib
    if _qr_lib is not None:
        return _qr_lib
    lib = ctypes.CDLL(str(build(SRC_QR, QR_LIB_NAME)))
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    sigs = {
        "ct_qr_factor": (i64, [i32, i32, i64p, i32p, f64p]),
        "ct_qr_factor_split": (i64, [i32, i32, i64p, i32p, f64p, i32]),
        "ct_qr_set_dense": (None, [f64p]),
        "ct_qr_diag": (None, [f64p]),
        "ct_qr_solve_multi": (i32, [i32, f64p, f64p]),
        "ct_qr_free": (None, []),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    _qr_lib = lib
    return lib


class SparseQR:
    """R of the QR of a CSR matrix by row-Givens with sparse R rows
    (native/__init__.py:339-443 of the JAX package). The factor lives in
    the library's global state: ONE SparseQR is live at a time, and making
    another invalidates the one before (its methods then raise)."""

    _live = None

    def __init__(self, nrows, ncols, indptr, indices, data,
                 schur_tail_split: "int | None" = None):
        """schur_tail_split: factor only the columns [0, split) by
        row-Givens and drop what reaches [split, ncols): the caller installs
        the trailing R_cc = chol(S)' by set_dense before diag() or a solve."""
        lib = get_qr_lib()
        self._lib = lib
        self.ncols = int(ncols)
        args = (int(nrows), int(ncols), np.ascontiguousarray(indptr, np.int64),
                np.ascontiguousarray(indices, np.int32),
                np.ascontiguousarray(data, np.float64))
        t0 = time.perf_counter()
        if schur_tail_split is None:
            nnz = lib.ct_qr_factor(*args)
        else:
            nnz = lib.ct_qr_factor_split(*args, int(schur_tail_split))
        self.factor_s = time.perf_counter() - t0
        self.nnz_R = int(nnz)
        SparseQR._live = self

    def _check_live(self):
        if SparseQR._live is not self:
            raise RuntimeError("another SparseQR replaced this one")

    def set_dense(self, Rcc: np.ndarray):
        """Installs the (m, m) row-major upper-triangular trailing block."""
        self._check_live()
        self._lib.ct_qr_set_dense(np.ascontiguousarray(Rcc, np.float64))

    def diag(self) -> np.ndarray:
        """|diag(R)|; 0.0 marks a structurally empty (rank-deficient) row."""
        self._check_live()
        d = np.zeros(self.ncols, np.float64)
        self._lib.ct_qr_diag(d)
        return d

    def solve_normal_multi(self, B) -> np.ndarray:
        """(A'A)^{-1} B = R^{-1} R^{-T} B for an (ncols, k) B."""
        self._check_live()
        B = np.ascontiguousarray(B, np.float64)
        X = np.zeros_like(B)
        if self._lib.ct_qr_solve_multi(B.shape[1], B, X) != 0:
            raise np.linalg.LinAlgError("rank-deficient R in sparse QR")
        return X

    def free(self):
        if SparseQR._live is self:
            self._lib.ct_qr_free()
            SparseQR._live = None
