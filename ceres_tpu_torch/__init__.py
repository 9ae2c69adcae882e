"""ceres_tpu_torch: the PyTorch and CUDA port of ceres_tpu for an NVIDIA H100.

The port's Problem takes parameter blocks one at a time or as arrays,
held constant or bounded, with autodiff, analytic, numeric-diff,
conditioned and normal-prior cost functions. It runs the public `solve()`
with Levenberg-Marquardt over DENSE_SCHUR, ITERATIVE_SCHUR, CGNR, DENSE_QR
or DENSE_NORMAL_CHOLESKY, and with DOGLEG (traditional or subspace) over
the exact ones, in the fused loop or, as the JAX package picks it, the
host loop with user IterationCallbacks, an EvaluationCallback,
update_state_every_iteration, iteration dumps and a solve time limit,
through hand-written CUDA kernels (ops/kernels.py, csrc/): on
the fused jt path for BAL bundle adjustment (models/bal.py), angle-axis or
quaternion cameras, with or without a robust loss; on the flat path for
other programs such as the libmv bundle adjuster (models/libmv.py); the
dense solvers for small problems without eliminable blocks, such as the
More-Garbow-Hillstrom corpus (models/mgh.py); in float64, float32 or the
mixed schedule, with mixed-precision solves and box bounds. It imports
torch and numpy only: nothing of jax and nothing of ceres_tpu.
"""
from .callbacks import EvaluationCallback, IterationCallback
from .cost_function import (
    AnalyticCostFunction,
    AutoDiffCostFunction,
    ConditionedCostFunction,
    CostFunction,
    NormalPrior,
    NumericDiffCostFunction,
    cost_function_to_functor,
)
from .loss import (
    ArctanLoss,
    CauchyLoss,
    ComposedLoss,
    HuberLoss,
    LossFunction,
    LossFunctionWrapper,
    ScaledLoss,
    SoftLOneLoss,
    TolerantLoss,
    TrivialLoss,
    TukeyLoss,
)
from .manifolds import (
    AutoDiffManifold,
    EigenQuaternionManifold,
    EuclideanManifold,
    LineManifold,
    Manifold,
    ProductManifold,
    QuaternionManifold,
    SphereManifold,
    SubsetManifold,
)
from .options import Options
from .problem import ParameterBlock, ParameterBlockArray, Problem, ResidualBlock
from .solver import solve
from .summary import IterationSummary, Summary
from .types import (
    CallbackReturnType,
    DoglegType,
    LinearSolverTerminationType,
    LinearSolverType,
    LoggingType,
    MinimizerType,
    NumericDiffMethodType,
    PreconditionerType,
    TerminationType,
    TrustRegionStrategyType,
)

__all__ = [
    "AnalyticCostFunction",
    "ArctanLoss",
    "AutoDiffCostFunction",
    "AutoDiffManifold",
    "CallbackReturnType",
    "CauchyLoss",
    "ComposedLoss",
    "ConditionedCostFunction",
    "CostFunction",
    "DoglegType",
    "EigenQuaternionManifold",
    "EuclideanManifold",
    "EvaluationCallback",
    "HuberLoss",
    "IterationCallback",
    "IterationSummary",
    "LineManifold",
    "LinearSolverTerminationType",
    "LinearSolverType",
    "LossFunction",
    "LoggingType",
    "LossFunctionWrapper",
    "Manifold",
    "MinimizerType",
    "NormalPrior",
    "NumericDiffCostFunction",
    "NumericDiffMethodType",
    "Options",
    "ParameterBlock",
    "ParameterBlockArray",
    "PreconditionerType",
    "Problem",
    "ProductManifold",
    "QuaternionManifold",
    "ResidualBlock",
    "ScaledLoss",
    "SoftLOneLoss",
    "SphereManifold",
    "SubsetManifold",
    "Summary",
    "TerminationType",
    "TolerantLoss",
    "TrivialLoss",
    "TrustRegionStrategyType",
    "TukeyLoss",
    "cost_function_to_functor",
    "solve",
]
