"""IterationSummary and Summary (counterpart of ceres_tpu/summary.py).

Same fields and report for what the port fills, plus `num_host_syncs`:
the fused LM loop waits for the device once per iteration (and once
before the first), the host loop (solvers/trust_region.py) about three
times per iteration, the iterative steps once more per CG iteration, and
each wait is counted here, with one per probe of a bounded problem's line
search. `linear_solver_iterations` of a row is its CG iteration count (1
for the exact steps). The host loop also fills the per-row and per-phase
times and counts (`jacobian_evaluation_time_in_seconds`,
`linear_solver_time_in_seconds`, the rows' `iteration_time_in_seconds`,
`step_solver_time_in_seconds` and `cumulative_time_in_seconds`).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from .types import (
    LinearSolverType,
    MinimizerType,
    PreconditionerType,
    TerminationType,
    TrustRegionStrategyType,
)


@dataclasses.dataclass
class IterationSummary:
    iteration: int = 0
    step_is_valid: bool = False
    step_is_nonmonotonic: bool = False
    step_is_successful: bool = False
    cost: float = 0.0
    cost_change: float = 0.0
    gradient_max_norm: float = 0.0
    gradient_norm: float = 0.0
    step_norm: float = 0.0
    relative_decrease: float = 0.0
    trust_region_radius: float = 0.0
    eta: float = 0.0
    step_size: float = 0.0
    line_search_function_evaluations: int = 0
    line_search_gradient_evaluations: int = 0
    line_search_iterations: int = 0
    linear_solver_iterations: int = 0
    iteration_time_in_seconds: float = 0.0
    step_solver_time_in_seconds: float = 0.0
    cumulative_time_in_seconds: float = 0.0


@dataclasses.dataclass
class Summary:
    minimizer_type: MinimizerType = MinimizerType.TRUST_REGION
    termination_type: TerminationType = TerminationType.FAILURE
    message: str = "ceres_tpu_torch::Solve was not called."
    initial_cost: float = -1.0
    final_cost: float = -1.0
    fixed_cost: float = -1.0
    iterations: List[IterationSummary] = dataclasses.field(default_factory=list)
    num_successful_steps: int = 0
    num_unsuccessful_steps: int = 0

    preprocessor_time_in_seconds: float = 0.0
    minimizer_time_in_seconds: float = 0.0
    postprocessor_time_in_seconds: float = 0.0
    total_time_in_seconds: float = 0.0
    linear_solver_time_in_seconds: float = 0.0
    num_linear_solves: int = 0
    num_residual_evaluations: int = 0
    jacobian_evaluation_time_in_seconds: float = 0.0
    num_jacobian_evaluations: int = 0
    # waits of the host for the device inside minimize()
    num_host_syncs: int = 0

    num_parameter_blocks: int = 0
    num_parameters: int = 0
    num_effective_parameters: int = 0
    num_residual_blocks: int = 0
    num_residuals: int = 0
    num_parameter_blocks_reduced: int = 0
    num_parameters_reduced: int = 0
    num_effective_parameters_reduced: int = 0
    num_residual_blocks_reduced: int = 0
    num_residuals_reduced: int = 0
    is_constrained: bool = False

    linear_solver_type_given: Optional[LinearSolverType] = None
    linear_solver_type_used: Optional[LinearSolverType] = None
    preconditioner_type_given: Optional[PreconditionerType] = None
    preconditioner_type_used: Optional[PreconditionerType] = None
    trust_region_strategy_type: Optional[TrustRegionStrategyType] = None
    schur_structure_given: str = ""
    schur_structure_used: str = ""

    device_kind: str = ""
    num_devices: int = 1

    def is_solution_usable(self) -> bool:
        return self.termination_type in (
            TerminationType.CONVERGENCE,
            TerminationType.NO_CONVERGENCE,
            TerminationType.USER_SUCCESS,
        )

    def brief_report(self) -> str:
        return (
            f"Ceres-TPU-Torch Solver Report: Iterations: {len(self.iterations)}, "
            f"Initial cost: {self.initial_cost:e}, Final cost: {self.final_cost:e}, "
            f"Termination: {self.termination_type}"
        )
