"""Fields-of-Experts image denoising (counterpart of
ceres_tpu/models/denoising.py; the reference's examples/denoising.cc and
fields_of_experts.{h,cc}).

A quadratic data term per pixel and, per filter, one linear filter
residual per patch under the FoE loss alpha log(1 + s/2). The problem is
built one residual block at a time, as the JAX package builds it: every
patch of one filter shares that filter's cost function and loss, so the
compiled program evaluates each filter as one batched kind over all
patches. The loss is a user LossFunction, so the solve takes the flat path
(ops/flatops.jt_refusal): CGNR there launches rows 6, 7 and 9.
"""
from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import torch

from ..cost_function import AutoDiffCostFunction
from ..loss import LossFunction
from ..problem import Problem

_TINY = float(np.finfo(np.float64).tiny)


@dataclasses.dataclass
class FieldsOfExperts:
    size: int
    x_delta: np.ndarray
    y_delta: np.ndarray
    alpha: np.ndarray  # (num_filters,)
    filters: np.ndarray  # (num_filters, size*size)

    @property
    def num_filters(self):
        return self.filters.shape[0]

    @property
    def num_variables(self):
        return self.size * self.size


def read_foe_file(path) -> FieldsOfExperts:
    vals = pathlib.Path(path).read_text().split()
    it = iter(vals)
    size = int(next(it))
    num_filters = int(next(it))
    nv = size * size
    x_delta = np.asarray([int(next(it)) for _ in range(nv)])
    y_delta = np.asarray([int(next(it)) for _ in range(nv)])
    alpha = np.asarray([float(next(it)) for _ in range(num_filters)])
    filters = np.asarray(
        [[float(next(it)) for _ in range(nv)] for _ in range(num_filters)]
    )
    return FieldsOfExperts(size, x_delta, y_delta, alpha, filters)


def read_pgm(path) -> np.ndarray:
    """Plain/raw PGM reader (examples/pgm_image.h)."""
    data = pathlib.Path(path).read_bytes()
    if data[:2] == b"P5":
        # header: magic, width, height, maxval then binary
        parts = []
        idx = 2
        while len(parts) < 3:
            # skip whitespace/comments
            while idx < len(data) and data[idx : idx + 1].isspace():
                idx += 1
            if data[idx : idx + 1] == b"#":
                while data[idx : idx + 1] != b"\n":
                    idx += 1
                continue
            start = idx
            while idx < len(data) and not data[idx : idx + 1].isspace():
                idx += 1
            parts.append(int(data[start:idx]))
        idx += 1  # single whitespace after maxval
        w, h, maxval = parts
        img = np.frombuffer(data[idx : idx + w * h], np.uint8).reshape(h, w)
        return img.astype(np.float64)
    if data[:2] == b"P2":
        lines = [
            ln for ln in data.decode().splitlines() if not ln.strip().startswith("#")
        ]
        toks = " ".join(lines).split()
        w, h = int(toks[1]), int(toks[2])
        vals = np.asarray([float(v) for v in toks[4 : 4 + w * h]])
        return vals.reshape(h, w)
    raise ValueError("not a PGM file")


def write_pgm(path, img: np.ndarray):
    img8 = np.clip(np.round(img), 0, 255).astype(np.uint8)
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(img8.tobytes())


class FoELoss(LossFunction):
    """rho(s) = alpha log(1 + s/2) (fields_of_experts.cc:77-84), rho' held
    at float64's smallest normal number or above."""

    def __init__(self, alpha: float):
        self.alpha = float(alpha)

    def evaluate(self, s):
        c = 0.5
        total = 1.0 + s * c
        inv = 1.0 / total
        rho0 = self.alpha * torch.log(total)
        rho1 = torch.clamp(self.alpha * c * inv, min=_TINY)
        rho2 = -self.alpha * c * c * inv * inv
        return rho0, rho1, rho2


def _filter_functor(coeffs: np.ndarray):
    c = tuple(float(v) for v in coeffs)

    def f(*px):
        vals = torch.stack([p[0] for p in px])
        return torch.sum(torch.tensor(c, dtype=vals.dtype, device=vals.device) * vals)

    return f


def create_problem(foe: FieldsOfExperts, noisy: np.ndarray, sigma: float):
    """denoising.cc CreateProblem: (problem, pixel blocks (h, w) of
    1-element arrays, which the solve writes into)."""
    h, w = noisy.shape
    pixels = [[np.asarray([noisy[y, x]], np.float64) for x in range(w)] for y in range(h)]
    problem = Problem()
    sqrt_a = float(np.sqrt(1.0 / (2.0 * sigma * sigma)))

    quad = AutoDiffCostFunction(lambda px, b: sqrt_a * (px[0] - b), 1, [1], name="quad_data")
    for y in range(h):
        for x in range(w):
            problem.add_residual_block(quad, None, [pixels[y][x]], data=np.float64(noisy[y, x]))

    # one cost function and loss per filter: each is one batched kind
    filter_costs = [(AutoDiffCostFunction(_filter_functor(foe.filters[fi]), 1,
                                          [1] * foe.num_variables, name=f"foe{fi}"),
                     FoELoss(foe.alpha[fi]))
                    for fi in range(foe.num_filters)]
    for x in range(w - foe.size + 1):
        for y in range(h - foe.size + 1):
            patch = [pixels[y + foe.y_delta[i]][x + foe.x_delta[i]]
                     for i in range(foe.num_variables)]
            for cost, loss in filter_costs:
                problem.add_residual_block(cost, loss, patch)
    return problem, pixels


def pixels_to_image(pixels) -> np.ndarray:
    return np.asarray([[p[0] for p in row] for row in pixels])
