"""Cubic Hermite interpolation of sampled data (counterpart of
ceres_tpu/cubic_interpolation.py).

CubicInterpolator and BiCubicInterpolator over Grid1D and Grid2D, with the
same Catmull-Rom kernel and clamped edges, so that sampled data (images,
lookup tables) can sit inside an AutoDiffCostFunction's functor. The
derivative comes from torch's autodiff through the spline's polynomial in
the fractional coordinate. The cells are read with `torch.index_select`,
which `torch.func.vmap` batches (indexing by a batched 0-d integer tensor
does not). A grid lives on the device of the values it is given.
"""
from __future__ import annotations

import torch


def _hermite(p0, p1, p2, p3, x):
    """Catmull-Rom cubic on [0, 1] through 4 control values."""
    a = 0.5 * (-p0 + 3.0 * p1 - 3.0 * p2 + p3)
    b = 0.5 * (2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3)
    c = 0.5 * (-p0 + p2)
    d = p1
    return d + x * (c + x * (b + x * a))


def _values(values, ndim):
    v = torch.as_tensor(values, dtype=torch.float64)
    return v[..., None] if v.ndim == ndim else v


def _coordinate(x, like):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        x, dtype=like.dtype, device=like.device)


def _cell(x, n):
    """floor(x) as an integer index clamped to [0, n - 1]."""
    return torch.clamp(torch.floor(x).to(torch.int64), 0, n - 1)


def _scalar_if_one(out):
    return out[0] if out.shape == (1,) else out


class Grid1D:
    """values (N,) or (N, dim), read with out-of-range indices clamped."""

    def __init__(self, values):
        self.values = _values(values, 1)
        self.n = self.values.shape[0]

    def __call__(self, i):
        i = torch.clamp(i, 0, self.n - 1)
        return torch.index_select(self.values, 0, i.reshape(1))[0]


class CubicInterpolator:
    """f(x) for x in [0, N - 1], differentiable by torch's autodiff."""

    def __init__(self, grid: Grid1D):
        self.grid = grid

    def evaluate(self, x):
        x = _coordinate(x, self.grid.values)
        n = _cell(x, self.grid.n)
        frac = x - n
        out = _hermite(self.grid(n - 1), self.grid(n), self.grid(n + 1),
                       self.grid(n + 2), frac)
        return _scalar_if_one(out)

    def __call__(self, x):
        return self.evaluate(x)


class Grid2D:
    """values (R, C) or (R, C, dim), row-major, read with clamped indices."""

    def __init__(self, values):
        self.values = _values(values, 2)
        self.rows, self.cols = self.values.shape[0], self.values.shape[1]
        self._flat = self.values.reshape(self.rows * self.cols, -1)

    def __call__(self, r, c):
        r = torch.clamp(r, 0, self.rows - 1)
        c = torch.clamp(c, 0, self.cols - 1)
        return torch.index_select(self._flat, 0, (r * self.cols + c).reshape(1))[0]


class BiCubicInterpolator:
    """f(r, c): the separable bicubic, a cubic along the columns of each of
    four rows, then along the rows."""

    def __init__(self, grid: Grid2D):
        self.grid = grid

    def evaluate(self, r, c):
        r = _coordinate(r, self.grid.values)
        c = _coordinate(c, self.grid.values)
        rf = _cell(r, self.grid.rows)
        cf = _cell(c, self.grid.cols)
        fr = r - rf
        fc = c - cf
        rows = []
        for dr in (-1, 0, 1, 2):
            cols = [self.grid(rf + dr, cf + dc) for dc in (-1, 0, 1, 2)]
            rows.append(_hermite(cols[0], cols[1], cols[2], cols[3], fc))
        out = _hermite(rows[0], rows[1], rows[2], rows[3], fr)
        return _scalar_if_one(out)

    def __call__(self, r, c):
        return self.evaluate(r, c)
