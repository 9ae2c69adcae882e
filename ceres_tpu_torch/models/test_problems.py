"""Canned linear least-squares problems shared by solver tests
(counterpart of ceres_tpu/models/test_problems.py).

The fixture semantics of linear_least_squares_problems.{h,cc}
(CreateLinearLeastSquaresProblemFromId, :64): small hand-built systems,
including the BA-structured problem #2 of the eliminator and
preconditioner tests, as explicit (J, D, b) numpy arrays, so that the
dense solvers (solvers/linear/dense.py) can be held against the known
solution of J'J + D'D.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class LinearLeastSquaresProblem:
    J: np.ndarray  # (m, n)
    b: np.ndarray  # (m,)
    D: Optional[np.ndarray]  # (n,) or None
    num_eliminate_cols: int = 0  # leading columns forming the e-partition
    x_expected: Optional[np.ndarray] = None


def problem_0() -> LinearLeastSquaresProblem:
    """Well conditioned 3x2 (linear_least_squares_problems.cc problem 0)."""
    J = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    b = np.array([1.0, 2.0, 3.0])
    D = np.array([1.0, 1.0])
    x = np.linalg.solve(J.T @ J + np.diag(D * D), J.T @ b)
    return LinearLeastSquaresProblem(J, b, D, 0, x)


def problem_1(seed=0) -> LinearLeastSquaresProblem:
    """Random overdetermined dense system."""
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((20, 6))
    b = rng.standard_normal(20)
    D = rng.uniform(0.5, 1.5, 6)
    x = np.linalg.solve(J.T @ J + np.diag(D * D), J.T @ b)
    return LinearLeastSquaresProblem(J, b, D, 0, x)


def problem_2() -> LinearLeastSquaresProblem:
    """The BA-structured problem (reference problem #2): 2 e-blocks of size
    1, 2 f-blocks of size 1, block-sparse rows — the eliminator test
    fixture shape."""
    # rows: (e0,f0) (e0,f1) (e1,f0) (e1,f1) + regularizer-ish rows
    J = np.array(
        [
            [1.0, 0.0, 2.0, 0.0],
            [3.0, 0.0, 0.0, 4.0],
            [0.0, 5.0, 6.0, 0.0],
            [0.0, 7.0, 0.0, 8.0],
            [0.0, 0.0, 9.0, 1.0],
        ]
    )
    b = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    D = np.array([1.0, 1.0, 1.0, 1.0])
    x = np.linalg.solve(J.T @ J + np.diag(D * D), J.T @ b)
    return LinearLeastSquaresProblem(J, b, D, num_eliminate_cols=2, x_expected=x)


PROBLEMS = {0: problem_0, 1: problem_1, 2: problem_2}


def create_linear_least_squares_problem(pid: int) -> LinearLeastSquaresProblem:
    return PROBLEMS[pid]()
