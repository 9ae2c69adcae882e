"""Gradient checking: a cost function's Jacobians against numeric
differentiation (counterpart of ceres_tpu/gradient_checker.py;
gradient_checker.h:66, gradient_checking_cost_function.cc, and the
check_gradients=true path of solver.cc:768-780 that ends the solve on a
wrong Jacobian).

The comparison is made in the tangent space (J_ambient PlusJacobian), with
Ridders' extrapolation (NumericDiffCostFunction, method RIDDERS) for the
numeric side, as the JAX module makes it. It runs on the host in float64,
one residual block at a time.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .cost_function import CostFunction, NumericDiffCostFunction
from .manifolds import Manifold
from .utils.tree import tree_map


@dataclasses.dataclass
class ProbeResults:
    """gradient_checker.h ProbeResults."""

    return_value: bool = True
    residuals: Optional[np.ndarray] = None
    jacobians: Optional[List[np.ndarray]] = None  # ambient
    numeric_jacobians: Optional[List[np.ndarray]] = None
    local_jacobians: Optional[List[np.ndarray]] = None  # tangent space
    local_numeric_jacobians: Optional[List[np.ndarray]] = None
    maximum_relative_error: float = 0.0
    error_log: str = ""


class GradientChecker:
    """Compare a cost function's Jacobians against numeric differentiation."""

    def __init__(self, cost: CostFunction,
                 manifolds: Optional[List[Optional[Manifold]]] = None,
                 relative_step_size: float = 1e-6):
        self.cost = cost
        n = len(cost.parameter_block_sizes)
        self.manifolds = manifolds or [None] * n
        self.numeric = NumericDiffCostFunction(
            lambda *a: cost.residuals(list(a[:n]), a[n] if len(a) > n else None),
            cost.num_residuals, cost.parameter_block_sizes, method="RIDDERS",
            ridders_relative_initial_step_size=relative_step_size)

    def probe(self, parameters, relative_precision: float, data=None) -> ProbeResults:
        r = ProbeResults()
        params = [torch.as_tensor(np.asarray(p, np.float64)) for p in parameters]
        data = tree_map(lambda a: torch.as_tensor(np.asarray(a)), data)
        res, jacs = self.cost.residuals_and_jacobians(params, data)
        _, num_jacs = self.numeric.residuals_and_jacobians(params, data)
        r.residuals = res.detach().numpy()
        r.jacobians = [J.detach().numpy() for J in jacs]
        r.numeric_jacobians = [J.detach().numpy() for J in num_jacs]
        r.local_jacobians, r.local_numeric_jacobians = [], []
        worst = 0.0
        log = []
        for i, (J, Jn) in enumerate(zip(r.jacobians, r.numeric_jacobians)):
            m = self.manifolds[i]
            if m is not None:
                P = m.plus_jacobian(params[i]).detach().numpy()
                Jl, Jnl = J @ P, Jn @ P
            else:
                Jl, Jnl = J, Jn
            r.local_jacobians.append(Jl)
            r.local_numeric_jacobians.append(Jnl)
            denom = np.maximum(np.abs(Jl), np.abs(Jnl))
            denom = np.where(denom == 0.0, 1.0, denom)
            rel = np.abs(Jl - Jnl) / denom
            # entries where both are ~0 are fine
            rel = np.where((np.abs(Jl) < 1e-12) & (np.abs(Jnl) < 1e-12), 0.0, rel)
            worst = max(worst, float(rel.max()) if rel.size else 0.0)
            if (rel > relative_precision).any():
                log.append(
                    f"Jacobian for parameter block {i} is incorrect; "
                    f"worst relative error {float(rel.max()):.3e} at "
                    f"{np.unravel_index(int(np.argmax(rel)), rel.shape)}")
        r.maximum_relative_error = worst
        if log:
            r.return_value = False
            r.error_log = "\n".join(log)
        return r


def check_problem_gradients(problem, relative_precision: float = 1e-8,
                            relative_step_size: float = 1e-6) -> Tuple[bool, str]:
    """The check_gradients=true path: probe every residual block added one
    at a time; on a failure return (False, message), and the solve ends
    before its first iteration (gradient_checking_cost_function.cc)."""
    checkers = {}
    for rb in problem.residual_blocks():
        checker = checkers.get(id(rb.cost))
        if checker is None:
            checker = GradientChecker(rb.cost, [b.manifold for b in rb.blocks],
                                      relative_step_size)
            checkers[id(rb.cost)] = checker
        result = checker.probe([b.values for b in rb.blocks], relative_precision, rb.data)
        if not result.return_value:
            return False, ("Gradient Error detected!\nTerminating solver because the "
                           f"gradients are wrong (residual block {rb.rb_id}):\n"
                           + result.error_log)
    return True, ""
