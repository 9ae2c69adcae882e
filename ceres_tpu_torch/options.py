"""Solver options and their validation (counterpart of ceres_tpu/options.py).

The fields are those the slice reads, with the JAX package's names and
defaults. `is_valid` mirrors the JAX validation for these fields;
`check_supported` raises NotImplementedError for a request that a later
slice of the port brings.
"""
from __future__ import annotations

import dataclasses

from .types import (
    DoglegType,
    LinearSolverType,
    MinimizerType,
    PreconditionerType,
    TrustRegionStrategyType,
    not_ported,
)


# The preconditioners of the ITERATIVE_SCHUR and CGNR paths: on
# ITERATIVE_SCHUR JACOBI runs as SCHUR_JACOBI, as in the JAX fused loop
# (fused_lm.py:237-239); on CGNR both are the block-Jacobi preconditioner
# of J'J (fused_lm.py:161).
_ITERATIVE_PRECONDITIONERS = (PreconditionerType.SCHUR_JACOBI,
                              PreconditionerType.JACOBI,
                              PreconditionerType.IDENTITY)
_PORTED_SOLVERS = (LinearSolverType.DENSE_SCHUR, LinearSolverType.ITERATIVE_SCHUR,
                   LinearSolverType.CGNR, LinearSolverType.DENSE_QR,
                   LinearSolverType.DENSE_NORMAL_CHOLESKY)
# DOGLEG runs on the exact solvers only (fused_lm.py:1925-1929)
_DOGLEG_SOLVERS = (LinearSolverType.DENSE_SCHUR, LinearSolverType.DENSE_QR,
                   LinearSolverType.DENSE_NORMAL_CHOLESKY)


@dataclasses.dataclass
class Options:
    minimizer_type: MinimizerType = MinimizerType.TRUST_REGION
    trust_region_strategy_type: TrustRegionStrategyType = (
        TrustRegionStrategyType.LEVENBERG_MARQUARDT)
    dogleg_type: DoglegType = DoglegType.TRADITIONAL_DOGLEG

    # Trust region
    use_nonmonotonic_steps: bool = False
    max_consecutive_nonmonotonic_steps: int = 5
    max_num_iterations: int = 50
    initial_trust_region_radius: float = 1e4
    max_trust_region_radius: float = 1e16
    min_trust_region_radius: float = 1e-32
    min_relative_decrease: float = 1e-3
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    max_num_consecutive_invalid_steps: int = 5
    function_tolerance: float = 1e-6
    gradient_tolerance: float = 1e-10
    parameter_tolerance: float = 1e-8
    jacobi_scaling: bool = True

    # "float64" or "float32": the dtype of residuals and Jacobians; the
    # solver state and the host-side control flow stay float64.
    evaluation_dtype: str = "float64"

    # The port runs the fused-loop form only; "NEVER" (the host loop)
    # is a later slice.
    fused_loop: str = "AUTO"

    # Linear solver
    linear_solver_type: LinearSolverType = LinearSolverType.SPARSE_NORMAL_CHOLESKY
    preconditioner_type: PreconditionerType = PreconditionerType.JACOBI
    use_explicit_schur_complement: bool = False
    use_mixed_precision_solves: bool = False
    max_num_refinement_iterations: int = 0
    min_linear_solver_iterations: int = 0
    max_linear_solver_iterations: int = 500
    use_spse_initialization: bool = False
    max_num_spse_iterations: int = 5
    eta: float = 1e-1
    use_inner_iterations: bool = False
    linear_solver_ordering: object = None
    minimizer_progress_to_stdout: bool = False

    def is_valid(self) -> "tuple[bool, str]":
        for name, lo in [
            ("max_num_iterations", 0),
            ("function_tolerance", 0.0),
            ("gradient_tolerance", 0.0),
            ("parameter_tolerance", 0.0),
            ("max_consecutive_nonmonotonic_steps", 1),
        ]:
            if getattr(self, name) < lo:
                return False, f"Options::{name} must be >= {lo}"
        for name in [
            "initial_trust_region_radius",
            "max_trust_region_radius",
            "min_trust_region_radius",
            "min_relative_decrease",
            "min_lm_diagonal",
            "max_lm_diagonal",
            "eta",
        ]:
            if getattr(self, name) <= 0:
                return False, f"Options::{name} must be > 0"
        if self.evaluation_dtype not in ("float64", "float32", "mixed"):
            return False, ("Options::evaluation_dtype must be one of "
                           "'float64', 'float32', 'mixed'")
        if self.min_trust_region_radius > self.max_trust_region_radius:
            return False, "min_trust_region_radius > max_trust_region_radius"
        if self.min_lm_diagonal > self.max_lm_diagonal:
            return False, "min_lm_diagonal > max_lm_diagonal"
        if self.use_mixed_precision_solves and self.linear_solver_type in (
                LinearSolverType.ITERATIVE_SCHUR, LinearSolverType.CGNR):
            return False, "mixed precision solves not supported with iterative solvers"
        return True, ""

    def check_supported(self) -> None:
        """Raise NotImplementedError for what this slice does not run."""
        if self.minimizer_type != MinimizerType.TRUST_REGION:
            raise not_ported(f"minimizer_type={self.minimizer_type}", 6)
        if self.linear_solver_type not in _PORTED_SOLVERS:
            raise not_ported(f"linear_solver_type={self.linear_solver_type}", 6)
        if (self.trust_region_strategy_type == TrustRegionStrategyType.DOGLEG
                and self.linear_solver_type not in _DOGLEG_SOLVERS):
            raise not_ported(f"DOGLEG with {self.linear_solver_type}", 6)
        if self.linear_solver_type in (LinearSolverType.ITERATIVE_SCHUR,
                                       LinearSolverType.CGNR):
            if self.preconditioner_type not in _ITERATIVE_PRECONDITIONERS:
                raise not_ported(
                    f"preconditioner_type={self.preconditioner_type}", 6)
        if self.linear_solver_type == LinearSolverType.ITERATIVE_SCHUR:
            if self.use_spse_initialization:
                raise not_ported("use_spse_initialization", 6)
            if self.use_explicit_schur_complement:
                raise not_ported("use_explicit_schur_complement", 6)
        if self.evaluation_dtype == "mixed" or self.use_mixed_precision_solves:
            raise not_ported("mixed-precision evaluation or solves", 5)
        if self.fused_loop.upper() == "NEVER":
            raise not_ported("the host LM loop (fused_loop='NEVER')", 6)
        if self.use_inner_iterations:
            raise not_ported("inner iterations", 6)
        if self.linear_solver_ordering is not None:
            raise not_ported("a user linear_solver_ordering", 6)
        if self.minimizer_progress_to_stdout:
            raise not_ported("minimizer_progress_to_stdout", 6)
