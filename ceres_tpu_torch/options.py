"""Solver options and their validation (counterpart of ceres_tpu/options.py).

The fields are those the port reads, with the JAX package's names and
defaults. `is_valid` mirrors the JAX validation for these fields;
`check_supported` raises NotImplementedError for a request that a later
slice of the port brings.
"""
from __future__ import annotations

import dataclasses
import tempfile
from typing import Any, Callable, List, Optional

from .types import (
    DoglegType,
    LinearSolverType,
    LoggingType,
    MinimizerType,
    PreconditionerType,
    TrustRegionStrategyType,
    not_ported,
)


# The preconditioners of the ITERATIVE_SCHUR and CGNR paths: on
# ITERATIVE_SCHUR JACOBI runs as SCHUR_JACOBI, as in the JAX package
# (fused_lm.py:237-239, bsr_kernels.py:174-175); on CGNR both are the
# block-Jacobi preconditioner of J'J (fused_lm.py:161, bsr_kernels.py:107-111).
_ITERATIVE_PRECONDITIONERS = (PreconditionerType.SCHUR_JACOBI,
                              PreconditionerType.JACOBI,
                              PreconditionerType.IDENTITY)
_PORTED_SOLVERS = (LinearSolverType.DENSE_SCHUR, LinearSolverType.ITERATIVE_SCHUR,
                   LinearSolverType.CGNR, LinearSolverType.DENSE_QR,
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
    max_solver_time_in_seconds: float = 1e9
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

    # Bounds: the projected Armijo backtracking on the step scale of a
    # bounded problem (fused_lm.py:1494-1528)
    min_line_search_step_size: float = 1e-9
    line_search_sufficient_function_decrease: float = 1e-4
    max_num_line_search_step_size_iterations: int = 20

    # "float64" or "float32": the dtype of residuals and Jacobians; the
    # solver state and the host-side control flow stay float64. "mixed":
    # a float32 solve to its own end, then up to
    # `mixed_precision_polish_iterations` float64 iterations from there
    # (solver.py:172-210).
    evaluation_dtype: str = "float64"
    mixed_precision_polish_iterations: int = 5

    # The minimizer (solver.py `_maybe_build_fused`): "ALWAYS" the fused
    # loop, "NEVER" the host loop (solvers/trust_region.py), "AUTO" the
    # fused loop from `fused_loop_min_residuals` residuals up, for the
    # configurations it takes (no callbacks, no iteration dumps, no finite
    # max_solver_time_in_seconds, DOGLEG on an exact solver only), the
    # host loop otherwise, as the JAX package picks (options.py:90-100).
    fused_loop: str = "AUTO"
    fused_loop_min_residuals: int = 8192

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
    # groups of parameter blocks or arrays; group 0 is eliminated first
    linear_solver_ordering: Optional[List[List[Any]]] = None

    # Logging, callbacks and dumps: the host loop's (callbacks.py,
    # solvers/trust_region.py)
    logging_type: LoggingType = LoggingType.PER_MINIMIZER_ITERATION
    minimizer_progress_to_stdout: bool = False
    callbacks: List[Callable] = dataclasses.field(default_factory=list)
    update_state_every_iteration: bool = False
    evaluation_callback: Optional[Any] = None  # .prepare_for_evaluation(...)
    trust_region_minimizer_iterations_to_dump: List[int] = dataclasses.field(
        default_factory=list)
    # the JAX default is "/tmp"; here the temporary directory TMPDIR names
    trust_region_problem_dump_directory: str = dataclasses.field(
        default_factory=tempfile.gettempdir)

    def is_valid(self) -> "tuple[bool, str]":
        for name, lo in [
            ("max_num_iterations", 0),
            ("max_solver_time_in_seconds", 0.0),
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
        if (self.minimizer_type == MinimizerType.TRUST_REGION
                and self.trust_region_strategy_type == TrustRegionStrategyType.DOGLEG
                and self.linear_solver_type in (LinearSolverType.ITERATIVE_SCHUR,
                                                LinearSolverType.CGNR)):
            return False, "DOGLEG only supports exact factorization-based linear solvers"
        if (self.linear_solver_type in (LinearSolverType.DENSE_SCHUR,
                                        LinearSolverType.SPARSE_SCHUR,
                                        LinearSolverType.ITERATIVE_SCHUR)
                and self.linear_solver_ordering is not None
                and any(len(g) == 0 for g in self.linear_solver_ordering)):
            return False, "linear_solver_ordering contains an empty group"
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
        if self.use_inner_iterations:
            raise not_ported("inner iterations", 6)
