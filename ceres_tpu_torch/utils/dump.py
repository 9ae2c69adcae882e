"""Per-iteration dumps of the linear least-squares problem (counterpart of
ceres_tpu/utils/dump.py; linear_least_squares_problems.cc:84
DumpLinearLeastSquaresProblem, trust_region_minimizer.cc:387-395).

The host loop writes iteration i's system under
Options.trust_region_problem_dump_directory as
`ceres_tpu_iteration_{i:03d}_{A,D,b,x}.txt`: A the Jacobian's nonzeros as
"row col value" triplets under a "rows cols nnz" line, D, b and x one
value a line under their length, in the JAX package's format.
"""
from __future__ import annotations

import pathlib

import numpy as np


def dump_linear_least_squares_problem(base: str, J, D=None, b=None, x=None) -> str:
    """J dense (m, n); D, b, x optional vectors (numpy)."""
    base = pathlib.Path(base)
    base.parent.mkdir(parents=True, exist_ok=True)
    J = np.asarray(J)
    m, n = J.shape
    rows, cols = np.nonzero(J)
    with open(f"{base}_A.txt", "w") as f:
        f.write(f"{m} {n} {len(rows)}\n")
        for r, c in zip(rows, cols):
            f.write(f"{r} {c} {J[r, c]:.18e}\n")
    for name, v in (("D", D), ("b", b), ("x", x)):
        if v is None:
            continue
        v = np.asarray(v)
        with open(f"{base}_{name}.txt", "w") as f:
            f.write(f"{v.shape[0]}\n")
            for val in v:
                f.write(f"{val:.18e}\n")
    return str(base)


def load_linear_least_squares_problem(base: str) -> dict:
    """The dump read back: {"J": dense, "D", "b", "x": vectors or None}."""
    base = pathlib.Path(base)
    out = {}
    with open(f"{base}_A.txt") as f:
        m, n, nnz = (int(v) for v in f.readline().split())
        J = np.zeros((m, n))
        for _ in range(nnz):
            r, c, v = f.readline().split()
            J[int(r), int(c)] = float(v)
    out["J"] = J
    for name in ("D", "b", "x"):
        p = pathlib.Path(f"{base}_{name}.txt")
        if p.exists():
            with open(p) as f:
                k = int(f.readline())
                out[name] = np.asarray([float(f.readline()) for _ in range(k)])
        else:
            out[name] = None
    return out
