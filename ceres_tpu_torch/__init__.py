"""ceres_tpu_torch: the PyTorch and CUDA port of ceres_tpu for an NVIDIA H100.

This slice runs the public `solve()` on a BAL bundle-adjustment problem
with DENSE_SCHUR and Levenberg-Marquardt, in the fused-loop form, through
four hand-written CUDA kernels (ops/kernels.py, csrc/). It imports torch
and numpy only: nothing of jax and nothing of ceres_tpu.
"""
from .cost_function import AutoDiffCostFunction, CostFunction
from .loss import LossFunction, TrivialLoss
from .options import Options
from .problem import ParameterBlockArray, Problem
from .solver import solve
from .summary import IterationSummary, Summary
from .types import (
    LinearSolverType,
    MinimizerType,
    PreconditionerType,
    TerminationType,
    TrustRegionStrategyType,
)

__all__ = [
    "AutoDiffCostFunction",
    "CostFunction",
    "IterationSummary",
    "LinearSolverType",
    "LossFunction",
    "MinimizerType",
    "Options",
    "ParameterBlockArray",
    "PreconditionerType",
    "Problem",
    "Summary",
    "TerminationType",
    "TrivialLoss",
    "TrustRegionStrategyType",
    "solve",
]
