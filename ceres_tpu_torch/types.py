"""Public enums (counterpart of ceres_tpu/types.py).

The enums that the port's options, solvers, cost functions and callbacks
read, the line-search ones included, which Options carries before a later
slice runs them. Names and members match the JAX package, so options
written for one package read the same in the other.
"""
from __future__ import annotations

import enum


class _StrEnum(enum.Enum):
    def __str__(self) -> str:  # DENSE_SCHUR -> "DENSE_SCHUR"
        return self.name

    @classmethod
    def parse(cls, s):
        if isinstance(s, cls):
            return s
        try:
            return cls[str(s).upper()]
        except KeyError:
            raise ValueError(f"Unknown {cls.__name__}: {s!r}") from None


class LinearSolverType(_StrEnum):
    DENSE_QR = enum.auto()
    DENSE_NORMAL_CHOLESKY = enum.auto()
    SPARSE_NORMAL_CHOLESKY = enum.auto()
    DENSE_SCHUR = enum.auto()
    SPARSE_SCHUR = enum.auto()
    ITERATIVE_SCHUR = enum.auto()
    CGNR = enum.auto()


class PreconditionerType(_StrEnum):
    IDENTITY = enum.auto()
    JACOBI = enum.auto()
    SCHUR_JACOBI = enum.auto()
    SCHUR_POWER_SERIES_EXPANSION = enum.auto()
    CLUSTER_JACOBI = enum.auto()
    CLUSTER_TRIDIAGONAL = enum.auto()
    SUBSET = enum.auto()


class MinimizerType(_StrEnum):
    TRUST_REGION = enum.auto()
    LINE_SEARCH = enum.auto()


class TrustRegionStrategyType(_StrEnum):
    LEVENBERG_MARQUARDT = enum.auto()
    DOGLEG = enum.auto()


class DoglegType(_StrEnum):
    TRADITIONAL_DOGLEG = enum.auto()
    SUBSPACE_DOGLEG = enum.auto()


class LineSearchDirectionType(_StrEnum):
    STEEPEST_DESCENT = enum.auto()
    NONLINEAR_CONJUGATE_GRADIENT = enum.auto()
    LBFGS = enum.auto()
    BFGS = enum.auto()


class NonlinearConjugateGradientType(_StrEnum):
    FLETCHER_REEVES = enum.auto()
    POLAK_RIBIERE = enum.auto()
    HESTENES_STIEFEL = enum.auto()


class LineSearchType(_StrEnum):
    ARMIJO = enum.auto()
    WOLFE = enum.auto()


class LineSearchInterpolationType(_StrEnum):
    BISECTION = enum.auto()
    QUADRATIC = enum.auto()
    CUBIC = enum.auto()


class TerminationType(_StrEnum):
    CONVERGENCE = enum.auto()
    NO_CONVERGENCE = enum.auto()
    FAILURE = enum.auto()
    USER_SUCCESS = enum.auto()
    USER_FAILURE = enum.auto()


class CallbackReturnType(_StrEnum):
    SOLVER_CONTINUE = enum.auto()
    SOLVER_ABORT = enum.auto()
    SOLVER_TERMINATE_SUCCESSFULLY = enum.auto()


class LinearSolverTerminationType(_StrEnum):
    """The outcome of one linear solve (linear_solver.h:57-74): FAILURE
    shrinks the trust region and retries, FATAL_ERROR ends the solve."""

    SUCCESS = enum.auto()
    NO_CONVERGENCE = enum.auto()
    FAILURE = enum.auto()
    FATAL_ERROR = enum.auto()


class LoggingType(_StrEnum):
    SILENT = enum.auto()
    PER_MINIMIZER_ITERATION = enum.auto()


class NumericDiffMethodType(_StrEnum):
    CENTRAL = enum.auto()
    FORWARD = enum.auto()
    RIDDERS = enum.auto()


class VisibilityClusteringType(_StrEnum):
    CANONICAL_VIEWS = enum.auto()
    SINGLE_LINKAGE = enum.auto()


# Later slices of the port, as ROADMAP.md numbers them. Features outside
# this slice raise NotImplementedError naming the slice that brings them.
LATER_SLICES = {
    4: "a device-resident LM loop (CUDA graphs)",
    6: "line search and inner iterations",
    9: "multi-device: the mesh half of parallel/sharded_ba.py, parallel/mesh.py "
       "and parallel/sharded_program.py",
}


def not_ported(feature: str, slice_no: int) -> NotImplementedError:
    """The error a request outside this slice raises."""
    return NotImplementedError(
        f"{feature} is not ported yet: ROADMAP.md, port slice {slice_no} "
        f"({LATER_SLICES[slice_no]})")
