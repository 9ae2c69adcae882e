"""ceres_tpu_torch: the PyTorch and CUDA port of ceres_tpu for an NVIDIA H100.

The port's Problem takes parameter blocks one at a time or as arrays,
held constant or bounded, with autodiff, analytic, numeric-diff,
conditioned and normal-prior cost functions. It runs the public `solve()`
with Levenberg-Marquardt over DENSE_SCHUR, ITERATIVE_SCHUR, CGNR, DENSE_QR
or DENSE_NORMAL_CHOLESKY, and with DOGLEG (traditional or subspace) over
the exact ones, in the fused loop or, as the JAX package picks it, the
host loop with user IterationCallbacks, an EvaluationCallback,
update_state_every_iteration, iteration dumps and a solve time limit; the
host loop also runs the sparse direct solvers SPARSE_NORMAL_CHOLESKY (the
default) and SPARSE_SCHUR and the SUBSET preconditioner, factoring on the
host with the port's own native sparse Cholesky (native/), for bundle
adjustment and the pose graphs of models/pose_graph.py;
through hand-written CUDA kernels (ops/kernels.py, csrc/): on
the fused jt path for BAL bundle adjustment (models/bal.py), angle-axis or
quaternion cameras, with or without a robust loss; on the flat path for
other programs such as the libmv bundle adjuster (models/libmv.py); the
dense solvers for small problems without eliminable blocks, such as the
More-Garbow-Hillstrom corpus (models/mgh.py); in float64, float32 or the
mixed schedule, with mixed-precision solves and box bounds; ITERATIVE_SCHUR
takes every preconditioner (SCHUR_JACOBI, the power series, the cluster
ones over visibility clustering) and the explicit Schur complement, and
check_gradients tests the user's Jacobians before a solve. Cubic
interpolation of sampled data sits inside autodiff functors, and
examples/ holds the JAX package's example scripts over these modules.
After a solve, Covariance returns blocks of (J'J)^{-1} (dense SVD, the
sparse QR of native/, with its camera core from the Schur complement on
the card, or the normal equations); TinySolver solves many small dense
problems in one batched LM loop; capi.py is the minimal functional API,
utils/profiling.py the phase timers, models/nist.py and
models/denoising.py the NIST StRD suite and Fields-of-Experts denoising.
It imports torch, numpy and scipy only: nothing of jax and nothing of
ceres_tpu.
"""
from .callbacks import EvaluationCallback, IterationCallback
from .covariance import Covariance, CovarianceOptions
from .cost_function import (
    AnalyticCostFunction,
    AutoDiffCostFunction,
    ConditionedCostFunction,
    CostFunction,
    NormalPrior,
    NumericDiffCostFunction,
    cost_function_to_functor,
)
from .cubic_interpolation import BiCubicInterpolator, CubicInterpolator, Grid1D, Grid2D
from .gradient_checker import GradientChecker
from .gradient_problem import GradientProblem, solve_gradient_problem
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
from .tiny_solver import TinySolver, TinySolverOptions, TinySolverSummary
from .types import (
    CallbackReturnType,
    CovarianceAlgorithmType,
    DoglegType,
    LineSearchDirectionType,
    LineSearchInterpolationType,
    LineSearchType,
    LinearSolverTerminationType,
    LinearSolverType,
    LoggingType,
    MinimizerType,
    NonlinearConjugateGradientType,
    NumericDiffMethodType,
    PreconditionerType,
    TerminationType,
    TrustRegionStrategyType,
    VisibilityClusteringType,
)

__all__ = [
    "AnalyticCostFunction",
    "ArctanLoss",
    "AutoDiffCostFunction",
    "AutoDiffManifold",
    "BiCubicInterpolator",
    "CallbackReturnType",
    "CauchyLoss",
    "ComposedLoss",
    "ConditionedCostFunction",
    "CostFunction",
    "Covariance",
    "CovarianceAlgorithmType",
    "CovarianceOptions",
    "CubicInterpolator",
    "DoglegType",
    "EigenQuaternionManifold",
    "EuclideanManifold",
    "EvaluationCallback",
    "GradientChecker",
    "GradientProblem",
    "Grid1D",
    "Grid2D",
    "HuberLoss",
    "IterationCallback",
    "IterationSummary",
    "LineManifold",
    "LineSearchDirectionType",
    "LineSearchInterpolationType",
    "LineSearchType",
    "LinearSolverTerminationType",
    "LinearSolverType",
    "LossFunction",
    "LoggingType",
    "LossFunctionWrapper",
    "Manifold",
    "MinimizerType",
    "NonlinearConjugateGradientType",
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
    "TinySolver",
    "TinySolverOptions",
    "TinySolverSummary",
    "TolerantLoss",
    "TrivialLoss",
    "TrustRegionStrategyType",
    "TukeyLoss",
    "VisibilityClusteringType",
    "cost_function_to_functor",
    "solve",
    "solve_gradient_problem",
]
