"""The NIST StRD nonlinear regression suite (counterpart of
ceres_tpu/models/nist.py; the reference's examples/nist.cc).

Reads the certified .dat problems, solves each from every certified start
and scores log-relative-error (LRE) digits against the certified minima
(ComputeLRE, nist.cc:595-613); success is LRE > 4 digits, the reference's
bar. Each problem is one residual block over the whole observation
vector, its observations the block's data, so they move to the solve's
device with the program. The solves run on the card unless device="cpu".
"""
from __future__ import annotations

import dataclasses
import math
import pathlib
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..cost_function import AutoDiffCostFunction
from ..options import Options
from ..problem import Problem
from ..solver import solve
from ..types import LinearSolverType, TrustRegionStrategyType

PI = math.pi


# --- model functions (nist.cc:346-478), y_hat = f(b, x) --------------------

def bennett5(b, x):
    return b[0] * (b[1] + x) ** (-1.0 / b[2])


def boxbod(b, x):
    return b[0] * (1.0 - torch.exp(-b[1] * x))


def chwirut(b, x):
    return torch.exp(-b[0] * x) / (b[1] + b[2] * x)


def danwood(b, x):
    return b[0] * x ** b[1]


def gauss(b, x):
    return (
        b[0] * torch.exp(-b[1] * x)
        + b[2] * torch.exp(-(((x - b[3]) / b[4]) ** 2))
        + b[5] * torch.exp(-(((x - b[6]) / b[7]) ** 2))
    )


def lanczos(b, x):
    return b[0] * torch.exp(-b[1] * x) + b[2] * torch.exp(-b[3] * x) + b[4] * torch.exp(-b[5] * x)


def hahn1(b, x):
    return (b[0] + b[1] * x + b[2] * x**2 + b[3] * x**3) / (
        1.0 + b[4] * x + b[5] * x**2 + b[6] * x**3
    )


def kirby2(b, x):
    return (b[0] + b[1] * x + b[2] * x**2) / (1.0 + b[3] * x + b[4] * x**2)


def mgh09(b, x):
    return b[0] * (x**2 + x * b[1]) / (x**2 + x * b[2] + b[3])


def mgh10(b, x):
    return b[0] * torch.exp(b[1] / (x + b[2]))


def mgh17(b, x):
    return b[0] + b[1] * torch.exp(-x * b[3]) + b[2] * torch.exp(-x * b[4])


def misra1a(b, x):
    return b[0] * (1.0 - torch.exp(-b[1] * x))


def misra1b(b, x):
    return b[0] * (1.0 - 1.0 / ((1.0 + b[1] * x / 2.0) ** 2))


def misra1c(b, x):
    return b[0] * (1.0 - (1.0 + 2.0 * b[1] * x) ** (-0.5))


def misra1d(b, x):
    return b[0] * b[1] * x / (1.0 + b[1] * x)


def roszman1(b, x):
    return b[0] - b[1] * x - torch.atan2(b[2], x - b[3]) / PI


def rat42(b, x):
    return b[0] / (1.0 + torch.exp(b[1] - b[2] * x))


def rat43(b, x):
    return b[0] / (1.0 + torch.exp(b[1] - b[2] * x)) ** (1.0 / b[3])


def thurber(b, x):
    return (b[0] + b[1] * x + b[2] * x**2 + b[3] * x**3) / (
        1.0 + b[4] * x + b[5] * x**2 + b[6] * x**3
    )


def enso(b, x):
    w = 2.0 * PI * x
    return (
        b[0]
        + b[1] * torch.cos(w / 12.0)
        + b[2] * torch.sin(w / 12.0)
        + b[4] * torch.cos(w / b[3])
        + b[5] * torch.sin(w / b[3])
        + b[7] * torch.cos(w / b[6])
        + b[8] * torch.sin(w / b[6])
    )


def eckerle4(b, x):
    return b[0] / b[1] * torch.exp(-0.5 * ((x - b[2]) / b[1]) ** 2)


def nelson_residual(b, xy):
    """Nelson uses log-response and two predictors (nist.cc:467-478)."""
    x1, x2, y = xy[:, 0], xy[:, 1], xy[:, 2]
    return torch.log(y) - (b[0] - b[1] * x1 * torch.exp(-b[2] * x2))


# name -> (model fn, num_parameters); difficulty tiers as in nist.cc:692-748.
SUITE = [
    # (dataset file, model, num_params, difficulty)
    ("Misra1a.dat", misra1a, 2, "easy"),
    ("Chwirut1.dat", chwirut, 3, "easy"),
    ("Chwirut2.dat", chwirut, 3, "easy"),
    ("Lanczos3.dat", lanczos, 6, "easy"),
    ("Gauss1.dat", gauss, 8, "easy"),
    ("Gauss2.dat", gauss, 8, "easy"),
    ("DanWood.dat", danwood, 2, "easy"),
    ("Misra1b.dat", misra1b, 2, "easy"),
    ("Kirby2.dat", kirby2, 5, "medium"),
    ("Hahn1.dat", hahn1, 7, "medium"),
    ("Nelson.dat", nelson_residual, 3, "medium"),
    ("MGH17.dat", mgh17, 5, "medium"),
    ("Lanczos1.dat", lanczos, 6, "medium"),
    ("Lanczos2.dat", lanczos, 6, "medium"),
    ("Gauss3.dat", gauss, 8, "medium"),
    ("Misra1c.dat", misra1c, 2, "medium"),
    ("Misra1d.dat", misra1d, 2, "medium"),
    ("Roszman1.dat", roszman1, 4, "medium"),
    ("ENSO.dat", enso, 9, "medium"),
    ("MGH09.dat", mgh09, 4, "hard"),
    ("Thurber.dat", thurber, 7, "hard"),
    ("BoxBOD.dat", boxbod, 2, "hard"),
    ("Rat42.dat", rat42, 3, "hard"),
    ("MGH10.dat", mgh10, 3, "hard"),
    ("Eckerle4.dat", eckerle4, 3, "hard"),
    ("Rat43.dat", rat43, 4, "hard"),
    ("Bennett5.dat", bennett5, 3, "hard"),
]


@dataclasses.dataclass
class NISTProblem:
    name: str
    predictors: np.ndarray  # (n_obs, n_pred)
    response: np.ndarray  # (n_obs,)
    initial_parameters: np.ndarray  # (n_starts, n_params)
    certified_parameters: np.ndarray  # (n_params,)
    certified_cost: float


def parse_nist_file(path) -> NISTProblem:
    """Parser for the StRD ASCII format (NISTProblem ctor, nist.cc:225-310)."""
    lines = pathlib.Path(path).read_text().splitlines()
    toks = [ln.split() for ln in lines]
    num_responses = int(toks[24][1])
    num_predictors = int(toks[25][0])
    num_obs = int(toks[26][0])
    num_params = int(toks[31][0])
    # Starting values begin at line 40 (0-indexed: row 40).
    start_row = 40
    first = toks[start_row]
    num_tries = len(first) - 4
    initial = np.zeros((num_tries, num_params))
    certified = np.zeros(num_params)
    for pid in range(num_params):
        row = toks[start_row + pid]
        for t in range(num_tries):
            initial[t, pid] = float(row[2 + t])
        certified[pid] = float(row[2 + num_tries])
    # Residual sum of squares line: "Residual Sum of Squares: <v>"
    rss = None
    for row in toks:
        if len(row) >= 5 and row[0] == "Residual" and row[1] == "Sum":
            rss = float(row[4])
            break
    data_start = None
    for i, row in enumerate(toks):
        if row and row[0] == "Data:" and i > 55:
            data_start = i + 1
            break
    raw = np.array(
        [[float(v) for v in row] for row in toks[data_start : data_start + num_obs]]
    )
    response = raw[:, :num_responses].reshape(num_obs)
    predictors = raw[:, num_responses : num_responses + num_predictors]
    return NISTProblem(
        name=pathlib.Path(path).stem,
        predictors=predictors,
        response=response,
        initial_parameters=initial,
        certified_parameters=certified,
        certified_cost=rss / 2.0 if rss is not None else float("nan"),
    )


def compute_lre(expected: np.ndarray, actual: np.ndarray) -> float:
    """Min over params of -log10(relative error), clamped to [0, 11]
    (nist.cc:595-613)."""
    lre = 12.0
    for e, a in zip(expected, actual):
        with np.errstate(divide="ignore"):
            t = -np.log10(abs(e - a) / abs(e)) if e != 0 else -np.log10(abs(a))
        lre = min(lre, max(0.0, min(11.0, t)))
    return lre


def make_problem(nist: NISTProblem, model: Callable, b: np.ndarray) -> Problem:
    """One residual block of every observation; the solve writes into b."""
    num_params = b.shape[0]
    n = nist.response.shape[0]
    if model is nelson_residual:
        xy = np.concatenate([nist.predictors, nist.response[:, None]], axis=1)
        cost = AutoDiffCostFunction(nelson_residual, n, [num_params], name="Nelson")
        data = xy
    else:
        cost = AutoDiffCostFunction(lambda bb, d: d[1] - model(bb, d[0]), n, [num_params],
                                    name=nist.name)
        data = (nist.predictors[:, 0].copy(), nist.response.copy())
    p = Problem()
    p.add_residual_block(cost, None, [b], data=data)
    return p


def default_options() -> Options:
    """nist.cc SetMinimizerOptions defaults: 10,000 iterations, eps
    tolerances, DENSE_QR under Levenberg-Marquardt."""
    eps = float(np.finfo(np.float64).eps)
    return Options(
        linear_solver_type=LinearSolverType.DENSE_QR,
        trust_region_strategy_type=TrustRegionStrategyType.LEVENBERG_MARQUARDT,
        max_num_iterations=10000,
        function_tolerance=eps,
        gradient_tolerance=eps,
        parameter_tolerance=eps,
        use_nonmonotonic_steps=False,
    )


def run_problem(data_dir, filename, model, num_params, options=None, device=None):
    """Solves from every certified start: [(lre, success, summary)]."""
    nist = parse_nist_file(pathlib.Path(data_dir) / filename)
    results = []
    for start in range(nist.initial_parameters.shape[0]):
        b = nist.initial_parameters[start].copy()
        s = solve(options or default_options(), make_problem(nist, model, b), device=device)
        lre = compute_lre(nist.certified_parameters, b)
        results.append((lre, lre > 4.0, s))
    return results


def run_suite(data_dir, options=None, subset: Optional[List[str]] = None, device=None,
              summaries: Optional[Dict[str, List]] = None):
    """The whole suite, or the files in `subset`: {file name: [(lre,
    success)]}. `summaries`, if given, receives each file's summaries."""
    out: Dict[str, List] = {}
    for filename, model, num_params, tier in SUITE:
        if subset is not None and filename not in subset:
            continue
        res = run_problem(data_dir, filename, model, num_params, options, device)
        out[filename] = [(lre, ok) for (lre, ok, _) in res]
        if summaries is not None:
            summaries[filename] = [s for (_, _, s) in res]
    return out
