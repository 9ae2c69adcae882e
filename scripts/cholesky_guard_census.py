"""The supernodal fast-path guard of the native sparse Cholesky: where the
JAX package's copy (a check of a descendant's first and last pending rows)
and the port's (every pending row) part, on analyzed and on built supernode
structures.

  1. A census of the descendant updates on random symmetric patterns in
     their natural order, analyzed under relaxed amalgamation at 20%, 50%
     and 90% explicit zeros (ct_super_guard_census): the updates, those
     whose rows are not consecutive rows of their target, and those among
     them whose two ends line up (where the JAX guard takes the fast path
     wrongly).
  2. The witness structure of tests/test_torch_sparse_cholesky.py (a
     descendant's padded row missing from its target, which holds another
     row in the same span), factored by the port's library and by the JAX
     package's (the same handle: both libraries lay the structure out
     alike), each L against numpy's dense Cholesky.

    python scripts/cholesky_guard_census.py [seeds]

Prints the census totals and each library's largest error. Takes about
half a minute on a CPU (the JAX library is built there if absent).
"""
import sys
from pathlib import Path

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))

from ceres_tpu_torch import native  # noqa: E402
from test_torch_sparse_cholesky import (  # noqa: E402
    WITNESS_ENTRIES,
    WITNESS_PATTERNS,
    _dense_L,
    random_pattern_spd,
)


def census(seeds: int):
    lib = native.get_lib()
    total = np.zeros(3, np.int64)
    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(30, 400))
        A = random_pattern_spd(n, float(rng.uniform(0.005, 0.08)), seed)
        ip, ix = A.indptr.astype(np.int64), A.indices.astype(np.int32)
        for relax in (0.2, 0.5, 0.9):
            Lp = np.zeros(n + 1, np.int64)
            h = lib.ct_super_analyze(n, ip, ix, 32, relax, Lp, np.zeros(n, np.int32))
            out = np.zeros(3, np.int64)
            lib.ct_super_guard_census(h, out)
            total += out
            lib.ct_super_free(h)
    print(f"census: {3 * seeds} analyzed structures, {total[0]} updates, {total[1]} not "
          f"consecutive in their target, {total[2]} whose two ends line up")


def witness():
    from ceres_tpu.native import get_lib as jax_lib

    lib = native.get_lib()
    n = len(WITNESS_PATTERNS)
    A = np.eye(n) * 10
    for i, j, v in WITNESS_ENTRIES:
        A[i, j] = A[j, i] = v
    C = sp.csr_matrix(A)
    C.sort_indices()
    ref = np.linalg.cholesky(A)
    ptr = np.concatenate([[0], np.cumsum([len(p) for p in WITNESS_PATTERNS])]).astype(np.int64)
    for name, factor in (("port", lib.ct_super_factor), ("JAX", jax_lib().ct_super_factor)):
        Lp = np.zeros(n + 1, np.int64)
        h = lib.ct_super_from_patterns(n, n, np.arange(n + 1, dtype=np.int32), ptr,
                                       np.concatenate(WITNESS_PATTERNS).astype(np.int32), Lp)
        Li, Lx = np.zeros(int(Lp[-1]), np.int32), np.zeros(int(Lp[-1]))
        ret = factor(h, C.indptr.astype(np.int64), C.indices.astype(np.int32),
                     C.data.astype(np.float64), Li, Lx)
        lib.ct_super_free(h)
        err = np.abs(_dense_L(n, Lp, Li, Lx) - ref).max()
        print(f"witness, {name} library: return {ret}, largest |L - L_dense| {err:.3e}")


if __name__ == "__main__":
    census(int(sys.argv[1]) if len(sys.argv) > 1 else 300)
    witness()
