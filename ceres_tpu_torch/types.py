"""Public enums of the slice (counterpart of ceres_tpu/types.py).

Only the enums that the DENSE_SCHUR and ITERATIVE_SCHUR
Levenberg-Marquardt paths read.
Names and members match the JAX package, so options written for one
package read the same in the other.
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


class TerminationType(_StrEnum):
    CONVERGENCE = enum.auto()
    NO_CONVERGENCE = enum.auto()
    FAILURE = enum.auto()
    USER_SUCCESS = enum.auto()
    USER_FAILURE = enum.auto()


# Later slices of the port, as ROADMAP.md numbers them. Features outside
# this slice raise NotImplementedError naming the slice that brings them.
LATER_SLICES = {
    3: "robust losses and manifolds inside eval_fused",
    4: "a device-resident LM loop (CUDA graphs)",
    5: 'evaluation_dtype="mixed" and mixed-precision solves',
    6: "the remaining linear solvers, preconditioners, minimizers and modeling API",
    9: "multi-device: the mesh half of parallel/sharded_ba.py, parallel/mesh.py "
       "and parallel/sharded_program.py",
}


def not_ported(feature: str, slice_no: int) -> NotImplementedError:
    """The error a request outside this slice raises."""
    return NotImplementedError(
        f"{feature} is not ported yet: ROADMAP.md, port slice {slice_no} "
        f"({LATER_SLICES[slice_no]})")
