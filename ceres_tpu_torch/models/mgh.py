"""More-Garbow-Hillstrom test problems 1-19 (counterpart of
ceres_tpu/models/mgh.py).

The classic MGH (TOMS 1981) nonlinear least-squares corpus, as exercised
by the reference's examples/more_garbow_hillstrom.cc:90-545, with the
certified optima and the bounds of Gay (1998). The success criterion is
the reference example's (:550-588): solve from initial_x * 10^trial,
compare the SUM of squares (2 * final cost) to the certified optimum at
>= 4 relative log digits.

Each residual is one torch expression over the whole residual vector, x
a single parameter block: `build_problem` makes one ParameterBlockArray
of one block and one batch of one residual block. Every problem here has
one parameter block and so no eliminable block set: it solves with
DENSE_QR (or DENSE_NORMAL_CHOLESKY). The constrained variants carry box
bounds on that block.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from ..cost_function import AutoDiffCostFunction
from ..options import Options
from ..problem import Problem
from ..solver import solve
from ..types import LinearSolverType


@dataclasses.dataclass(frozen=True)
class MGHProblem:
    number: int
    name: str
    residual: Callable  # x (n,) -> (m,)
    num_residuals: int
    initial_x: tuple
    lower_bounds: Optional[tuple]  # None = unbounded
    upper_bounds: Optional[tuple]
    unconstrained_optimal_cost: float  # sum of squares at the optimum
    constrained_optimal_cost: Optional[float]  # None when not certified


def _c(values, x):
    """A constant vector in x's dtype and device."""
    return torch.tensor(values, dtype=x.dtype, device=x.device)


def _arange(a, b, x):
    return torch.arange(a, b, dtype=x.dtype, device=x.device)


def _rosenbrock(x):
    return torch.stack([10.0 * (x[1] - x[0] ** 2), 1.0 - x[0]])


def _freudenstein_roth(x):
    x1, x2 = x[0], x[1]
    return torch.stack([
        -13.0 + x1 + ((5.0 - x2) * x2 - 2.0) * x2,
        -29.0 + x1 + ((x2 + 1.0) * x2 - 14.0) * x2,
    ])


def _powell_badly_scaled(x):
    return torch.stack([
        1e4 * x[0] * x[1] - 1.0,
        torch.exp(-x[0]) + torch.exp(-x[1]) - 1.0001,
    ])


def _brown_badly_scaled(x):
    return torch.stack([x[0] - 1e6, x[1] - 2e-6, x[0] * x[1] - 2.0])


def _beale(x):
    x1, x2 = x[0], x[1]
    c = _c([1.5, 2.25, 2.625], x)
    p = _c([1.0, 2.0, 3.0], x)
    return c - x1 * (1.0 - x2 ** p)


def _jennrich_sampson(x):
    i = _arange(1.0, 11.0, x)
    return 2.0 + 2.0 * i - (torch.exp(i * x[0]) + torch.exp(i * x[1]))


def _helical_valley(x):
    x1, x2, x3 = x[0], x[1], x[2]
    theta = 0.5 / np.pi * torch.arctan(x2 / x1) + torch.where(
        x1 > 0.0, torch.zeros_like(x1), torch.full_like(x1, 0.5))
    return torch.stack([
        10.0 * (x3 - 10.0 * theta),
        10.0 * (torch.sqrt(x1 * x1 + x2 * x2) - 1.0),
        x3,
    ])


_BARD_Y = [0.14, 0.18, 0.22, 0.25, 0.29, 0.32, 0.35, 0.39, 0.37, 0.58, 0.73, 0.96,
           1.34, 2.10, 4.39]


def _bard(x):
    i = _arange(1.0, 16.0, x)
    u, v, w = i, 16.0 - i, torch.minimum(i, 16.0 - i)
    return _c(_BARD_Y, x) - (x[0] + u / (v * x[1] + w * x[2]))


_GAUSS_Y = [0.0009, 0.0044, 0.0175, 0.0540, 0.1295, 0.2420, 0.3521, 0.3989, 0.3521,
            0.2420, 0.1295, 0.0540, 0.0175, 0.0044, 0.0009]


def _gaussian(x):
    t = (7.0 - _arange(0.0, 15.0, x)) / 2.0
    return x[0] * torch.exp(-x[1] * (t - x[2]) ** 2 / 2.0) - _c(_GAUSS_Y, x)


_MEYER_Y = [34780.0, 28610.0, 23650.0, 19630.0, 16370.0, 13720.0, 11540.0, 9744.0,
            8261.0, 7030.0, 6005.0, 5147.0, 4427.0, 3820.0, 3307.0, 2872.0]


def _meyer(x):
    t = 45.0 + 5.0 * _arange(1.0, 17.0, x)
    return x[0] * torch.exp(x[1] / (t + x[2])) - _c(_MEYER_Y, x)


def _gulf(x):
    # textbook MGH #11, as the JAX package writes it (mgh.py:119-125)
    t = _arange(1.0, 100.0, x) / 100.0
    y = 25.0 + (-50.0 * torch.log(t)) ** (2.0 / 3.0)
    return torch.exp(-torch.abs(y - x[1]) ** x[2] / x[0]) - t


def _box3d(x):
    t = _c([0.1, 0.2, 0.3], x)
    return (torch.exp(-t * x[0]) - torch.exp(-t * x[1])
            - x[2] * (torch.exp(-t) - torch.exp(-10.0 * t)))


def _powell_singular(x):
    return torch.stack([
        x[0] + 10.0 * x[1],
        np.sqrt(5.0) * (x[2] - x[3]),
        (x[1] - 2.0 * x[2]) ** 2,
        np.sqrt(10.0) * (x[0] - x[3]) ** 2,
    ])


def _wood(x):
    return torch.stack([
        10.0 * (x[1] - x[0] ** 2),
        1.0 - x[0],
        np.sqrt(90.0) * (x[3] - x[2] ** 2),
        1.0 - x[2],
        np.sqrt(10.0) * (x[1] + x[3] - 2.0),
        (x[1] - x[3]) / np.sqrt(10.0),
    ])


_KOWALIK_Y = [0.1957, 0.1947, 0.1735, 0.1600, 0.0844, 0.0627, 0.0456, 0.0342, 0.0323,
              0.0235, 0.0246]
_KOWALIK_U = [4.0, 2.0, 1.0, 0.5, 0.25, 0.167, 0.125, 0.1, 0.0833, 0.0714, 0.0625]


def _kowalik_osborne(x):
    u = _c(_KOWALIK_U, x)
    return _c(_KOWALIK_Y, x) - x[0] * (u * u + u * x[1]) / (u * u + u * x[2] + x[3])


def _brown_dennis(x):
    t = _arange(1.0, 21.0, x) / 5.0
    return ((x[0] + t * x[1] - torch.exp(t)) ** 2
            + (x[2] + x[3] * torch.sin(t) - torch.cos(t)) ** 2)


_OSBORNE1_Y = [0.844, 0.908, 0.932, 0.936, 0.925, 0.908, 0.881, 0.850, 0.818, 0.784,
               0.751, 0.718, 0.685, 0.658, 0.628, 0.603, 0.580, 0.558, 0.538, 0.522,
               0.506, 0.490, 0.478, 0.467, 0.457, 0.448, 0.438, 0.431, 0.424, 0.420,
               0.414, 0.411, 0.406]


def _osborne1(x):
    t = 10.0 * _arange(0.0, 33.0, x)
    return _c(_OSBORNE1_Y, x) - (x[0] + x[1] * torch.exp(-t * x[3])
                                 + x[2] * torch.exp(-t * x[4]))


def _biggs_exp6(x):
    t = 0.1 * _arange(1.0, 14.0, x)
    y = torch.exp(-t) - 5.0 * torch.exp(-10.0 * t) + 3.0 * torch.exp(-4.0 * t)
    return (x[2] * torch.exp(-t * x[0]) - x[3] * torch.exp(-t * x[1])
            + x[5] * torch.exp(-t * x[4]) - y)


_OSBORNE2_Y = [
    1.366, 1.191, 1.112, 1.013, 0.991, 0.885, 0.831, 0.847, 0.786, 0.725,
    0.746, 0.679, 0.608, 0.655, 0.616, 0.606, 0.602, 0.626, 0.651, 0.724,
    0.649, 0.649, 0.694, 0.644, 0.624, 0.661, 0.612, 0.558, 0.533, 0.495,
    0.500, 0.423, 0.395, 0.375, 0.372, 0.391, 0.396, 0.405, 0.428, 0.429,
    0.523, 0.562, 0.607, 0.653, 0.672, 0.708, 0.633, 0.668, 0.645, 0.632,
    0.591, 0.559, 0.597, 0.625, 0.739, 0.710, 0.729, 0.720, 0.636, 0.581,
    0.428, 0.292, 0.162, 0.098, 0.054]


def _osborne2(x):
    t = _arange(0.0, 65.0, x) / 10.0
    return _c(_OSBORNE2_Y, x) - (
        x[0] * torch.exp(-t * x[4])
        + x[1] * torch.exp(-((t - x[8]) ** 2) * x[5])
        + x[2] * torch.exp(-((t - x[9]) ** 2) * x[6])
        + x[3] * torch.exp(-((t - x[10]) ** 2) * x[7])
    )


PROBLEMS: List[MGHProblem] = [
    MGHProblem(1, "Rosenbrock", _rosenbrock, 2, (-1.2, 1.0),
               None, None, 0.0, None),
    MGHProblem(2, "Freudenstein-Roth", _freudenstein_roth, 2, (0.5, -2.0),
               None, None, 0.0, None),
    MGHProblem(3, "Powell badly scaled", _powell_badly_scaled, 2, (0.0, 1.0),
               (0.0, 1.0), (1.0, 9.0), 0.0, 0.15125900e-9),
    MGHProblem(4, "Brown badly scaled", _brown_badly_scaled, 3, (1.0, 1.0),
               (0.0, 0.00003), (1000000.0, 100.0), 0.0, 0.78400000e3),
    MGHProblem(5, "Beale", _beale, 3, (1.0, 1.0),
               (0.6, 0.5), (10.0, 100.0), 0.0, 0.0),
    MGHProblem(6, "Jennrich-Sampson", _jennrich_sampson, 10, (1.0, 1.0),
               None, None, 124.362, None),
    MGHProblem(7, "Helical valley", _helical_valley, 3, (-1.0, 0.0, 0.0),
               (-100.0, -1.0, -1.0), (0.8, 1.0, 1.0), 0.0, 0.99042212),
    MGHProblem(8, "Bard", _bard, 15, (1.0, 1.0, 1.0),
               None, None, 8.21487e-3, None),
    MGHProblem(9, "Gaussian", _gaussian, 15, (0.4, 1.0, 0.0),
               (0.398, 1.0, -0.5), (4.2, 2.0, 0.1), 0.112793e-7,
               0.11279300e-7),
    MGHProblem(10, "Meyer", _meyer, 16, (0.02, 4000.0, 250.0),
               None, None, 87.9458, None),
    MGHProblem(11, "Gulf R&D", _gulf, 99, (5.0, 2.5, 0.15),
               (1e-16, 0.0, 0.0), (10.0, 10.0, 10.0), 0.0, None),
    MGHProblem(12, "Box 3D", _box3d, 3, (0.0, 10.0, 20.0),
               (0.0, 5.0, 0.0), (2.0, 9.5, 20.0), 0.0, 0.30998153e-5),
    MGHProblem(13, "Powell singular", _powell_singular, 4,
               (3.0, -1.0, 0.0, 1.0), None, None, 0.0, None),
    MGHProblem(14, "Wood", _wood, 6, (-3.0, -1.0, -3.0, -1.0),
               (-100.0, -100.0, -100.0, -100.0), (0.0, 10.0, 100.0, 100.0),
               0.0, 0.15567008e1),
    MGHProblem(15, "Kowalik-Osborne", _kowalik_osborne, 11,
               (0.25, 0.39, 0.415, 0.39), None, None, 3.07505e-4, None),
    MGHProblem(16, "Brown-Dennis", _brown_dennis, 20, (25.0, 5.0, -5.0, -1.0),
               (-10.0, 0.0, -100.0, -20.0), (100.0, 15.0, 0.0, 0.2),
               85822.2, 0.88860479e5),
    MGHProblem(17, "Osborne 1", _osborne1, 33, (0.5, 1.5, -1.0, 0.01, 0.02),
               None, None, 5.46489e-5, None),
    MGHProblem(18, "Biggs EXP6", _biggs_exp6, 13, (1.0, 2.0, 1.0, 1.0, 1.0, 1.0),
               (0.0, 0.0, 0.0, 1.0, 0.0, 0.0), (2.0, 8.0, 1.0, 7.0, 5.0, 5.0),
               0.0, 0.53209865e-3),
    MGHProblem(19, "Osborne 2", _osborne2, 65,
               (1.3, 0.65, 0.65, 0.7, 0.6, 3.0, 5.0, 7.0, 2.0, 4.5, 5.5),
               None, None, 4.01377e-2, None),
]


def build_problem(p: MGHProblem, constrained: bool = False, trial: int = 0):
    """(Problem, x): x (1, n), initial_x scaled by 10^trial as in the
    reference example; its row is the one parameter block, added with the
    per-block API and, when constrained, the certified bounds set per
    coordinate (mgh.py:258-272). solve writes the answer into x."""
    x = np.asarray(p.initial_x, np.float64)[None, :] * (10.0 ** trial)
    block = x[0]
    prob = Problem()
    n = len(p.initial_x)
    prob.add_residual_block(AutoDiffCostFunction(p.residual, p.num_residuals, [n]),
                            None, [block])
    if constrained:
        if p.lower_bounds is None:
            raise ValueError(f"problem {p.number} has no certified bounds")
        for i, (lo, hi) in enumerate(zip(p.lower_bounds, p.upper_bounds)):
            prob.set_parameter_lower_bound(block, i, lo)
            prob.set_parameter_upper_bound(block, i, hi)
    return prob, x


def solve_problem(p: MGHProblem, constrained: bool = False, trial: int = 0,
                  options_overrides=None, device=None):
    """(success, sum of squares, summary) with the reference's >= 4
    relative-log-digit criterion; on the card unless device="cpu"."""
    prob, _ = build_problem(p, constrained, trial)
    kw = dict(
        linear_solver_type=LinearSolverType.DENSE_QR,
        parameter_tolerance=1e-18,
        function_tolerance=1e-18,
        gradient_tolerance=1e-18,
        max_num_iterations=1000,
    )
    kw.update(options_overrides or {})
    s = solve(Options(**kw), prob, device=device)
    optimal = (p.constrained_optimal_cost if constrained
               else p.unconstrained_optimal_cost)
    if optimal is None or not np.isfinite(s.final_cost):
        return False, 2.0 * s.final_cost, s
    achieved = 2.0 * s.final_cost
    lre = -np.log10(abs(achieved - optimal) / (optimal if optimal > 0 else 1.0)
                    + 1e-300)
    return lre >= 4.0, achieved, s


def run_suite(constrained: bool = False, trials=(0,), verbose: bool = False,
              options_overrides=None, device=None):
    """Solve every (certified) problem; returns {number: [success per trial]}."""
    results = {}
    for p in PROBLEMS:
        if constrained and p.constrained_optimal_cost is None:
            continue
        row = []
        for t in trials:
            ok, achieved, _ = solve_problem(p, constrained, t, options_overrides, device)
            row.append(ok)
            if verbose:
                print(f"MGH {p.number:2d} {p.name:22s} trial {t}: "
                      f"{'PASS' if ok else 'fail'} (2*cost={achieved:.6g})")
        results[p.number] = row
    return results
