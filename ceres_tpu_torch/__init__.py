"""ceres_tpu_torch: the PyTorch and CUDA port of ceres_tpu for an NVIDIA H100.

The port runs the public `solve()` in the fused-loop form with
Levenberg-Marquardt over DENSE_SCHUR, ITERATIVE_SCHUR, CGNR, DENSE_QR or
DENSE_NORMAL_CHOLESKY, and with DOGLEG (traditional or subspace) over the
exact ones, through hand-written CUDA kernels (ops/kernels.py, csrc/): on
the fused jt path for BAL bundle adjustment (models/bal.py), angle-axis or
quaternion cameras, with or without a robust loss; on the flat path for
other programs such as the libmv bundle adjuster (models/libmv.py); the
dense solvers for small problems without eliminable blocks, such as the
More-Garbow-Hillstrom corpus (models/mgh.py). It imports torch and numpy
only: nothing of jax and nothing of ceres_tpu.
"""
from .cost_function import AutoDiffCostFunction, CostFunction
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
    EigenQuaternionManifold,
    EuclideanManifold,
    Manifold,
    ProductManifold,
    QuaternionManifold,
    SubsetManifold,
)
from .options import Options
from .problem import ParameterBlockArray, Problem
from .solver import solve
from .summary import IterationSummary, Summary
from .types import (
    DoglegType,
    LinearSolverType,
    MinimizerType,
    PreconditionerType,
    TerminationType,
    TrustRegionStrategyType,
)

__all__ = [
    "ArctanLoss",
    "AutoDiffCostFunction",
    "CauchyLoss",
    "ComposedLoss",
    "CostFunction",
    "DoglegType",
    "EigenQuaternionManifold",
    "EuclideanManifold",
    "HuberLoss",
    "IterationSummary",
    "LinearSolverType",
    "LossFunction",
    "LossFunctionWrapper",
    "Manifold",
    "MinimizerType",
    "Options",
    "ParameterBlockArray",
    "PreconditionerType",
    "Problem",
    "ProductManifold",
    "QuaternionManifold",
    "ScaledLoss",
    "SoftLOneLoss",
    "SubsetManifold",
    "Summary",
    "TerminationType",
    "TolerantLoss",
    "TrivialLoss",
    "TrustRegionStrategyType",
    "TukeyLoss",
    "solve",
]
