"""Solver options and their validation (counterpart of ceres_tpu/options.py).

Every field of the JAX Options, with its name and default (the dump
directory defaults to the temporary directory instead of "/tmp").
`is_valid` mirrors the JAX validation. `spse_tolerance`, `num_threads`
and `inner_iteration_ordering` are read by nothing, as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
import enum
import tempfile
from typing import Any, Callable, List, Optional, Sequence

from .types import (
    DoglegType,
    LineSearchDirectionType,
    LineSearchInterpolationType,
    LineSearchType,
    LinearSolverType,
    LoggingType,
    MinimizerType,
    NonlinearConjugateGradientType,
    PreconditionerType,
    TrustRegionStrategyType,
    VisibilityClusteringType,
)

@dataclasses.dataclass
class Options:
    minimizer_type: MinimizerType = MinimizerType.TRUST_REGION
    trust_region_strategy_type: TrustRegionStrategyType = (
        TrustRegionStrategyType.LEVENBERG_MARQUARDT)
    dogleg_type: DoglegType = DoglegType.TRADITIONAL_DOGLEG

    # Line search (solver.h:81-260): a later slice runs it
    line_search_direction_type: LineSearchDirectionType = LineSearchDirectionType.LBFGS
    line_search_type: LineSearchType = LineSearchType.WOLFE
    nonlinear_conjugate_gradient_type: NonlinearConjugateGradientType = (
        NonlinearConjugateGradientType.FLETCHER_REEVES)
    max_lbfgs_rank: int = 20
    use_approximate_eigenvalue_bfgs_scaling: bool = False
    line_search_interpolation_type: LineSearchInterpolationType = (
        LineSearchInterpolationType.CUBIC)
    max_line_search_step_contraction: float = 1e-3
    min_line_search_step_contraction: float = 0.6
    max_num_line_search_direction_restarts: int = 5
    line_search_sufficient_curvature_decrease: float = 0.9
    max_line_search_step_expansion: float = 10.0

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
    # CLUSTER_JACOBI and CLUSTER_TRIDIAGONAL: how the cameras are clustered
    visibility_clustering_type: VisibilityClusteringType = (
        VisibilityClusteringType.CANONICAL_VIEWS)
    use_explicit_schur_complement: bool = False
    use_mixed_precision_solves: bool = False
    max_num_refinement_iterations: int = 0
    min_linear_solver_iterations: int = 0
    max_linear_solver_iterations: int = 500
    use_spse_initialization: bool = False
    max_num_spse_iterations: int = 5
    spse_tolerance: float = 0.1
    eta: float = 1e-1
    # SPARSE_NORMAL_CHOLESKY: analyze the numeric pattern of J'J anew at
    # every solve (dynamic_sparse_normal_cholesky_solver.cc)
    dynamic_sparsity: bool = False
    # Inner iterations (solver.h:634-715): a later slice runs them
    use_inner_iterations: bool = False
    inner_iteration_tolerance: float = 1e-3
    inner_iteration_ordering: Optional[List[List[Any]]] = None
    # accepted as in the JAX package; the card's parallelism is the kernels'
    num_threads: int = 1
    # groups of parameter blocks or arrays; group 0 is eliminated first
    linear_solver_ordering: Optional[List[List[Any]]] = None
    # SUBSET on CGNR: the ids (Problem.add_residual_block's) of the residual
    # blocks whose rows form the preconditioner
    residual_blocks_for_subset_preconditioner: Optional[Sequence[int]] = None

    # Logging, callbacks and dumps: the host loop's (callbacks.py,
    # solvers/trust_region.py)
    logging_type: LoggingType = LoggingType.PER_MINIMIZER_ITERATION
    minimizer_progress_to_stdout: bool = False
    callbacks: List[Callable] = dataclasses.field(default_factory=list)
    update_state_every_iteration: bool = False
    evaluation_callback: Optional[Any] = None  # .prepare_for_evaluation(...)

    # Gradient checking (solver.cc:768-780): each residual block's Jacobians
    # against Ridders' numeric ones before the solve (gradient_checker.py)
    check_gradients: bool = False
    gradient_check_relative_precision: float = 1e-8
    gradient_check_numeric_derivative_relative_step_size: float = 1e-6

    trust_region_minimizer_iterations_to_dump: List[int] = dataclasses.field(
        default_factory=list)
    # the JAX default is "/tmp"; here the temporary directory TMPDIR names
    trust_region_problem_dump_directory: str = dataclasses.field(
        default_factory=tempfile.gettempdir)

    def fingerprint(self) -> tuple:
        """The scalar and enum fields as a hashable key (the JAX package's
        solver.py:106-119): what a fused minimizer bakes in. Fields that are
        not hashable (callbacks, orderings) are left out; the fused gates
        require them empty, and the e-families carry the ordering."""
        parts = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None or isinstance(v, (int, float, str, bool, enum.Enum)):
                parts.append((f.name, v))
        return tuple(parts)

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
        if (self.minimizer_type == MinimizerType.LINE_SEARCH
                and self.line_search_direction_type in (LineSearchDirectionType.BFGS,
                                                        LineSearchDirectionType.LBFGS)
                and self.line_search_type != LineSearchType.WOLFE):
            return False, ("BFGS/LBFGS line search directions require WOLFE line "
                           "search (Armijo does not guarantee the curvature "
                           "condition needed for a valid secant update)")
        if (self.linear_solver_type in (LinearSolverType.DENSE_SCHUR,
                                        LinearSolverType.SPARSE_SCHUR,
                                        LinearSolverType.ITERATIVE_SCHUR)
                and self.linear_solver_ordering is not None
                and any(len(g) == 0 for g in self.linear_solver_ordering)):
            return False, "linear_solver_ordering contains an empty group"
        if self.use_mixed_precision_solves and self.linear_solver_type in (
                LinearSolverType.ITERATIVE_SCHUR, LinearSolverType.CGNR):
            return False, "mixed precision solves not supported with iterative solvers"
        if (self.dynamic_sparsity
                and self.linear_solver_type != LinearSolverType.SPARSE_NORMAL_CHOLESKY):
            return False, "dynamic_sparsity is only supported with SPARSE_NORMAL_CHOLESKY"
        return True, ""
