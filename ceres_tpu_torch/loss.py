"""Robust loss functions and the Triggs corrector (counterpart of
ceres_tpu/loss.py).

Every loss maps s -> (rho, rho', rho'') elementwise over a tensor of
squared norms, in the tensor's dtype: the `_TINY` clamps are taken in
that dtype too, so in float32 they clamp at 0, as the JAX package's
weakly typed constant does. `correct_residuals_and_jacobians` is the host
corrector that the plain evaluation (`CompiledProgram._eval_core`) and the
flat path use.

The fused evaluation kernel (csrc/eval_fused.cu) takes a loss as a
`LossChain`: the built-in losses, ComposedLoss, ScaledLoss and
LossFunctionWrapper flattened on the host into at most MAX_CHAIN
elementary ops (`flatten_loss`), applied innermost first by the chain
rule of ComposedLoss. `evaluate_chain` is the same chain in PyTorch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

_TINY = float(2.2250738585072014e-308)  # DBL_MIN, like std::numeric_limits min


def _floor(x: torch.Tensor, lo: float) -> torch.Tensor:
    """max(x, lo) with lo taken in x's dtype (0 for _TINY in float32)."""
    return torch.maximum(x, torch.full_like(x, lo))


class LossFunction:
    """rho(s) and its first two derivatives, elementwise over s."""

    def evaluate(self, s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
        raise NotImplementedError

    def __call__(self, s):
        return self.evaluate(s)


@dataclasses.dataclass(frozen=True)
class TrivialLoss(LossFunction):
    """rho(s) = s (no robustification)."""

    def evaluate(self, s):
        return s, torch.ones_like(s), torch.zeros_like(s)


@dataclasses.dataclass(frozen=True)
class HuberLoss(LossFunction):
    """Quadratic for s <= a^2, linear beyond (loss_function.cc:52-65)."""

    a: float

    def evaluate(self, s):
        b = self.a * self.a
        r = torch.sqrt(_floor(s, _TINY))
        outlier = s > b
        rho0 = torch.where(outlier, 2.0 * self.a * r - b, s)
        rho1 = torch.where(outlier, _floor(self.a / r, _TINY), torch.ones_like(s))
        rho2 = torch.where(outlier, -rho1 / (2.0 * _floor(s, _TINY)),
                           torch.zeros_like(s))
        return rho0, rho1, rho2


@dataclasses.dataclass(frozen=True)
class SoftLOneLoss(LossFunction):
    """rho(s) = 2 b (sqrt(1 + s/b) - 1) (loss_function.cc:68-75)."""

    a: float

    def evaluate(self, s):
        b = self.a * self.a
        c = 1.0 / b
        total = 1.0 + s * c
        tmp = torch.sqrt(total)
        rho0 = 2.0 * b * (tmp - 1.0)
        rho1 = _floor(1.0 / tmp, _TINY)
        rho2 = -(c * rho1) / (2.0 * total)
        return rho0, rho1, rho2


@dataclasses.dataclass(frozen=True)
class CauchyLoss(LossFunction):
    """rho(s) = b log(1 + s/b) (loss_function.cc:77-84)."""

    a: float

    def evaluate(self, s):
        b = self.a * self.a
        c = 1.0 / b
        total = 1.0 + s * c
        inv = 1.0 / total
        rho0 = b * torch.log(total)
        rho1 = _floor(inv, _TINY)
        rho2 = -c * inv * inv
        return rho0, rho1, rho2


@dataclasses.dataclass(frozen=True)
class ArctanLoss(LossFunction):
    """rho(s) = a atan2(s, a) (loss_function.cc:86-93)."""

    a: float

    def evaluate(self, s):
        b = 1.0 / (self.a * self.a)
        inv = 1.0 / (1.0 + s * s * b)
        rho0 = self.a * torch.atan2(s, torch.full_like(s, self.a))
        rho1 = _floor(inv, _TINY)
        rho2 = -2.0 * s * b * inv * inv
        return rho0, rho1, rho2


@dataclasses.dataclass(frozen=True)
class TolerantLoss(LossFunction):
    """Flat near zero, linear beyond `a` with transition width `b`
    (loss_function.cc:101-119)."""

    a: float
    b: float

    def evaluate(self, s):
        a, b = self.a, self.b
        c = b * math.log1p(math.exp(-a / b))  # rho(0) offset so rho(0) == 0
        x = (s - a) / b
        # the reference's x > kLog2Max overflow branch
        big = x > 36.0
        xs = torch.where(big, torch.zeros_like(x), x)
        e_x = torch.exp(xs)
        rho0 = torch.where(big, s - a - c, b * torch.log1p(e_x) - c)
        rho1 = torch.where(big, torch.ones_like(s), _floor(e_x / (1.0 + e_x), _TINY))
        rho2 = torch.where(big, torch.zeros_like(s), 0.5 / (b * (1.0 + torch.cosh(xs))))
        return rho0, rho1, rho2


@dataclasses.dataclass(frozen=True)
class TukeyLoss(LossFunction):
    """Biweight: zero gradient beyond `a` (loss_function.cc:122-136)."""

    a: float

    def evaluate(self, s):
        a2 = self.a * self.a
        inlier = s <= a2
        zero = torch.zeros_like(s)
        value = torch.where(inlier, 1.0 - s / a2, zero)
        value_sq = value * value
        rho0 = torch.where(inlier, a2 / 3.0 * (1.0 - value_sq * value),
                           torch.full_like(s, a2 / 3.0))
        rho1 = torch.where(inlier, value_sq, zero)
        rho2 = torch.where(inlier, -2.0 / a2 * value, zero)
        return rho0, rho1, rho2


@dataclasses.dataclass(frozen=True)
class ComposedLoss(LossFunction):
    """rho(s) = f(g(s)) (loss_function.cc:156-165)."""

    f: LossFunction
    g: LossFunction

    def evaluate(self, s):
        g0, g1, g2 = self.g.evaluate(s)
        f0, f1, f2 = self.f.evaluate(g0)
        return f0, f1 * g1, f2 * g1 * g1 + f1 * g2


@dataclasses.dataclass(frozen=True)
class ScaledLoss(LossFunction):
    """rho(s) = a * wrapped(s); wrapped None means a * s
    (loss_function.cc:167-177)."""

    rho: Optional[LossFunction]
    a: float

    def evaluate(self, s):
        if self.rho is None:
            return self.a * s, torch.full_like(s, self.a), torch.zeros_like(s)
        r0, r1, r2 = self.rho.evaluate(s)
        return self.a * r0, self.a * r1, self.a * r2


class LossFunctionWrapper(LossFunction):
    """Mutable holder, so that the loss can be swapped between solves
    (loss_function.h LossFunctionWrapper). A solve reads the loss when it
    compiles the problem."""

    def __init__(self, rho: Optional[LossFunction]):
        self.rho = rho

    def reset(self, rho: Optional[LossFunction]):
        self.rho = rho

    def evaluate(self, s):
        if self.rho is None:
            return TrivialLoss().evaluate(s)
        return self.rho.evaluate(s)


# ---------------------------------------------------------------------------
# The Triggs corrector (corrector.cc:41-111), batched over residual blocks
# ---------------------------------------------------------------------------


def corrector_coefficients(sq_norm, rho1, rho2):
    """Per block (residual scaling, alpha / sq_norm, sqrt(rho')): first-order
    scaling only at zero residual or where rho'' <= 0, else the clamped
    Triggs rank-1 curvature correction."""
    sqrt_rho1 = torch.sqrt(rho1)
    simple = (sq_norm == 0.0) | (rho2 <= 0.0)
    zero = torch.zeros_like(sq_norm)
    safe_sq = torch.where(simple, torch.ones_like(sq_norm), sq_norm)
    D = 1.0 + 2.0 * safe_sq * torch.where(simple, zero, rho2) / rho1
    alpha = 1.0 - torch.sqrt(torch.clamp(D, min=0.0))
    residual_scaling = torch.where(simple, sqrt_rho1, sqrt_rho1 / (1.0 - alpha))
    alpha_sq_norm = torch.where(simple, zero, alpha / safe_sq)
    return residual_scaling, alpha_sq_norm, sqrt_rho1


def correct_residuals_and_jacobians(loss: Optional[LossFunction], residuals, jacobians):
    """A robust loss applied to a kind's residuals (B, r) and Jacobian
    blocks [(B, r, p_i)]. Returns (cost per block, corrected residuals,
    corrected Jacobians), in ResidualBlock::Evaluate's order
    (residual_block.cc:176-194): J corrected with the raw residuals, then
    the residuals scaled; the cost is rho(|r|^2) / 2."""
    sq_norm = torch.sum(residuals * residuals, dim=-1)
    if loss is None or isinstance(loss, TrivialLoss):
        return 0.5 * sq_norm, residuals, jacobians
    rho0, rho1, rho2 = loss.evaluate(sq_norm)
    res_scale, alpha_sq_norm, sqrt_rho1 = corrector_coefficients(sq_norm, rho1, rho2)
    new_jacs = []
    for J in jacobians:
        # J <- sqrt(rho') (J - alpha/s r (r'J)), batched over B
        rTj = torch.einsum("br,brp->bp", residuals, J)
        corr = J - alpha_sq_norm[:, None, None] * residuals[:, :, None] * rTj[:, None, :]
        new_jacs.append(sqrt_rho1[:, None, None] * corr)
    new_res = res_scale[:, None] * residuals
    return 0.5 * rho0, new_res, new_jacs


# ---------------------------------------------------------------------------
# The loss as the fused evaluation kernel takes it
# ---------------------------------------------------------------------------

# op codes of a chain, as csrc/eval_fused.cu numbers them
HUBER, SOFT_L_ONE, CAUCHY, ARCTAN, TOLERANT, TUKEY, SCALE = range(1, 8)
MAX_CHAIN = 4
_BASE = {HuberLoss: HUBER, SoftLOneLoss: SOFT_L_ONE, CauchyLoss: CAUCHY,
         ArctanLoss: ARCTAN, TukeyLoss: TUKEY}


class LossOp(NamedTuple):
    code: int
    a: float
    b: float = 0.0


class LossChain(NamedTuple):
    """A loss as at most MAX_CHAIN ops applied to (s, 1, 0) innermost
    first; the empty chain is the trivial loss."""

    ops: Tuple[LossOp, ...] = ()


def _ops(loss) -> Optional[Tuple[LossOp, ...]]:
    if loss is None or type(loss) is TrivialLoss:
        return ()
    if type(loss) in _BASE:
        return (LossOp(_BASE[type(loss)], float(loss.a)),)
    if type(loss) is TolerantLoss:
        return (LossOp(TOLERANT, float(loss.a), float(loss.b)),)
    if type(loss) is ScaledLoss:
        inner = _ops(loss.rho)
        return None if inner is None else inner + (LossOp(SCALE, float(loss.a)),)
    if type(loss) is ComposedLoss:
        f, g = _ops(loss.f), _ops(loss.g)
        return None if f is None or g is None else g + f
    if type(loss) is LossFunctionWrapper:
        return _ops(loss.rho)
    return None  # a user's own LossFunction


def flatten_loss(loss) -> Optional[LossChain]:
    """The chain of a loss built of the built-in ones, or None where the
    loss is not (a user's own LossFunction) or takes more than MAX_CHAIN
    ops."""
    ops = _ops(loss)
    if ops is None or len(ops) > MAX_CHAIN:
        return None
    return LossChain(ops)


def _base_loss(op: LossOp) -> LossFunction:
    if op.code == TOLERANT:
        return TolerantLoss(op.a, op.b)
    return {c: cls for cls, c in _BASE.items()}[op.code](op.a)


def evaluate_chain(chain: LossChain, s: torch.Tensor):
    """(rho, rho', rho'') of a chain: each op f applied to (g0, g1, g2)
    gives (f0(g0), f1(g0) g1, f2(g0) g1^2 + f1(g0) g2), a scale a gives
    (a g0, a g1, a g2), as ComposedLoss and ScaledLoss compute them."""
    g = (s, torch.ones_like(s), torch.zeros_like(s))
    for i, op in enumerate(chain.ops):
        if op.code == SCALE:
            g = (op.a * g[0], op.a * g[1], op.a * g[2])
            continue
        f0, f1, f2 = _base_loss(op).evaluate(g[0])
        g = (f0, f1, f2) if i == 0 else (f0, f1 * g[1], f2 * g[1] * g[1] + f1 * g[2])
    return g
