"""Manifolds: tangent-space parameterizations (counterpart of
ceres_tpu/manifolds.py).

The manifolds whose PlusJacobian the fused evaluation takes
(`supports_rows_columns`): Euclidean, Subset, Quaternion, EigenQuaternion
and their products. Each acts on one block: `plus`, `minus` and their
Jacobians take single (ambient,) and (tangent,) vectors, and batch under
torch.func.vmap. `plus_jacobian_columns_rows` gives the PlusJacobian's
columns for many blocks at once, in the transposed row form (ambient,
rows) that the JAX fused kernel feeds as jvp tangents. SphereManifold,
LineManifold and AutoDiffManifold have no such form: a program with one
takes the flat path (ops/flatops.jt_refusal), their Jacobians by
torch.func.jacfwd of plus and minus.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rotation


def _atan2_over_s(s2, c):
    """atan2(sqrt(s2), c) / sqrt(s2), with the Taylor limit 1/c - s2/(3c^3)
    where s2 -> 0, so that forward-mode derivatives are exact at the
    branch point (for c > 0)."""
    eps = float(np.finfo(np.float64).eps)
    small = s2 <= eps
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    exact = torch.atan2(s, c) / s
    safe_c = torch.where(c == 0, torch.ones_like(c), c)
    taylor = 1.0 / safe_c - s2 / (3.0 * safe_c ** 3)
    return torch.where(small, taylor, exact)


class Manifold:
    """manifold.h:148-221:

    plus(x, delta)    -> x [+] delta                (ambient, tangent) -> ambient
    minus(y, x)       -> y [-] x                    (ambient, ambient) -> tangent
    plus_jacobian(x)  -> (ambient, tangent) d plus(x, delta) / d delta at 0
    minus_jacobian(x) -> (tangent, ambient) d minus(y, x) / d y at y = x
    """

    ambient_size: int
    tangent_size: int

    def plus(self, x, delta):
        raise NotImplementedError

    def minus(self, y, x):
        raise NotImplementedError

    def plus_jacobian(self, x):
        zero = torch.zeros((self.tangent_size,), dtype=x.dtype, device=x.device)
        return torch.func.jacfwd(lambda d: self.plus(x, d))(zero)

    def minus_jacobian(self, x):
        return torch.func.jacfwd(lambda y: self.minus(y, x))(x)

    #: True where plus_jacobian_columns_rows is implemented
    supports_rows_columns = False

    def plus_jacobian_columns_rows(self, x_rows):
        """Column d of PlusJacobian(x) for every row at once: x_rows holds
        the block states transposed, (>= ambient, rows); returns a list of
        tangent_size tensors (ambient, rows), or None where unsupported."""
        return None

    def batch_key(self):
        """Manifolds that compare equal batch together; by default each
        instance is its own group."""
        return (type(self).__name__, id(self))

    def __repr__(self):
        return (f"{type(self).__name__}(ambient={self.ambient_size}, "
                f"tangent={self.tangent_size})")


def _unit_columns(indices, size, x_rows):
    rows = x_rows.shape[1]
    out = []
    for i in indices:
        c = x_rows.new_zeros((size, rows))
        c[int(i)] = 1.0
        out.append(c)
    return out


class EuclideanManifold(Manifold):
    """plus = x + delta (manifold.h EuclideanManifold)."""

    supports_rows_columns = True

    def __init__(self, size: int):
        self.ambient_size = size
        self.tangent_size = size

    def plus(self, x, delta):
        return x + delta

    def minus(self, y, x):
        return y - x

    def plus_jacobian(self, x):
        return torch.eye(self.ambient_size, dtype=x.dtype, device=x.device)

    def minus_jacobian(self, x):
        return torch.eye(self.ambient_size, dtype=x.dtype, device=x.device)

    def plus_jacobian_columns_rows(self, x_rows):
        return _unit_columns(range(self.ambient_size), self.ambient_size, x_rows)

    def batch_key(self):
        return ("Euclidean", self.ambient_size)


class SubsetManifold(Manifold):
    """Holds a subset of the coordinates constant (manifold.h:311), through
    a 0/1 selection matrix (ambient, tangent)."""

    supports_rows_columns = True

    def __init__(self, size: int, constant_indices):
        self.ambient_size = size
        self.constant_indices = tuple(sorted(int(i) for i in constant_indices))
        if len(set(self.constant_indices)) != len(self.constant_indices):
            raise ValueError("duplicate constant indices")
        for i in self.constant_indices:
            if not 0 <= i < size:
                raise ValueError(f"constant index {i} out of range [0,{size})")
        self._free = np.asarray([i for i in range(size)
                                 if i not in self.constant_indices], dtype=np.int64)
        self.tangent_size = len(self._free)
        sel = np.zeros((size, self.tangent_size))
        sel[self._free, np.arange(self.tangent_size)] = 1.0
        self._sel = sel

    def _selection(self, x):
        return torch.as_tensor(self._sel, dtype=x.dtype, device=x.device)

    def plus(self, x, delta):
        return x + self._selection(x) @ delta

    def minus(self, y, x):
        return self._selection(x).T @ (y - x)

    def plus_jacobian(self, x):
        return self._selection(x)

    def minus_jacobian(self, x):
        return self._selection(x).T

    def plus_jacobian_columns_rows(self, x_rows):
        return _unit_columns(self._free, self.ambient_size, x_rows)

    def batch_key(self):
        return ("Subset", self.ambient_size, self.constant_indices)


class QuaternionManifold(Manifold):
    """Unit quaternion [w, x, y, z]; delta is an angle-axis-like 3-vector
    of angle |delta| (manifold.h:360; manifold.cc:14-103)."""

    ambient_size = 4
    tangent_size = 3
    supports_rows_columns = True
    #: storage order -> [w, x, y, z] index map (EigenQuaternion overrides)
    _WXYZ_IDX = (0, 1, 2, 3)

    def _to_wxyz(self, q):
        return q[..., list(self._WXYZ_IDX)]

    def _from_wxyz(self, q):
        return q[..., list(np.argsort(self._WXYZ_IDX))]

    def plus(self, x, delta):
        norm2 = torch.sum(delta * delta)
        pos = norm2 > 0
        safe = torch.sqrt(torch.where(pos, norm2, torch.ones_like(norm2)))
        one = torch.ones_like(norm2)
        sin_by = torch.where(pos, torch.sin(safe) / safe, one)
        q_delta = torch.cat([torch.where(pos, torch.cos(safe), one)[None],
                             sin_by * delta])
        return self._from_wxyz(rotation.quaternion_product(q_delta, self._to_wxyz(x)))

    def minus(self, y, x):
        d = rotation.quaternion_product(self._to_wxyz(y),
                                        rotation.quaternion_conjugate(self._to_wxyz(x)))
        u = d[1:]
        # k = atan2(|u|, w) / |u|, with the Taylor branch at |u| -> 0
        return _atan2_over_s(torch.sum(u * u), d[0]) * u

    def _plus_jacobian_wxyz(self, w, qx, qy, qz):
        """PlusJacobian's rows in [w, x, y, z] order, each a list of 3."""
        return [[-qx, -qy, -qz], [w, qz, -qy], [-qz, w, qx], [qy, -qx, w]]

    def plus_jacobian(self, x):
        w, qx, qy, qz = self._to_wxyz(x).unbind(-1)
        rows = self._plus_jacobian_wxyz(w, qx, qy, qz)
        inv = np.argsort(self._WXYZ_IDX)
        return torch.stack([torch.stack(rows[int(inv[i])]) for i in range(4)])

    def minus_jacobian(self, x):
        w, qx, qy, qz = self._to_wxyz(x).unbind(-1)
        J = [[-qx, w, -qz, qy], [-qy, qz, w, -qx], [-qz, -qy, qx, w]]
        inv = np.argsort(self._WXYZ_IDX)
        return torch.stack([torch.stack([row[int(inv[i])] for i in range(4)])
                            for row in J])

    def plus_jacobian_columns_rows(self, x_rows):
        w, qx, qy, qz = (x_rows[i] for i in self._WXYZ_IDX)
        rows = self._plus_jacobian_wxyz(w, qx, qy, qz)
        inv = np.argsort(self._WXYZ_IDX)
        return [torch.stack([rows[int(inv[i])][d] for i in range(4)])
                for d in range(3)]

    def batch_key(self):
        return ("Quaternion",)


class EigenQuaternionManifold(QuaternionManifold):
    """The same manifold in Eigen's storage order [x, y, z, w]
    (manifold.h:384)."""

    _WXYZ_IDX = (3, 0, 1, 2)

    def batch_key(self):
        return ("EigenQuaternion",)


class ProductManifold(Manifold):
    """Cartesian product of manifolds (product_manifold.h)."""

    def __init__(self, *manifolds: Manifold):
        if not manifolds:
            raise ValueError("ProductManifold needs at least one factor")
        self.manifolds = tuple(manifolds)
        self.ambient_size = sum(m.ambient_size for m in manifolds)
        self.tangent_size = sum(m.tangent_size for m in manifolds)
        self._asizes = [m.ambient_size for m in manifolds]
        self._tsizes = [m.tangent_size for m in manifolds]

    def plus(self, x, delta):
        return torch.cat([m.plus(xi, di) for m, xi, di in zip(
            self.manifolds, torch.split(x, self._asizes), torch.split(delta, self._tsizes))])

    def minus(self, y, x):
        return torch.cat([m.minus(yi, xi) for m, yi, xi in zip(
            self.manifolds, torch.split(y, self._asizes), torch.split(x, self._asizes))])

    @staticmethod
    def _block_diag(blocks):
        """The blocks on the diagonal, by padding and concatenation, which
        torch.func.vmap batches (it runs torch.block_diag one block at a
        time)."""
        width = sum(b.shape[-1] for b in blocks)
        rows, off = [], 0
        for b in blocks:
            rows.append(torch.nn.functional.pad(b, (off, width - off - b.shape[-1])))
            off += b.shape[-1]
        return torch.cat(rows, dim=-2)

    def plus_jacobian(self, x):
        return self._block_diag([m.plus_jacobian(xi) for m, xi in zip(
            self.manifolds, torch.split(x, self._asizes))])

    def minus_jacobian(self, x):
        return self._block_diag([m.minus_jacobian(xi) for m, xi in zip(
            self.manifolds, torch.split(x, self._asizes))])

    @property
    def supports_rows_columns(self):
        return all(m.supports_rows_columns for m in self.manifolds)

    def plus_jacobian_columns_rows(self, x_rows):
        cols = []
        a_off = 0
        for m in self.manifolds:
            sub = m.plus_jacobian_columns_rows(x_rows[a_off:a_off + m.ambient_size])
            if sub is None:
                return None
            for c in sub:
                full = x_rows.new_zeros((self.ambient_size, x_rows.shape[1]))
                full[a_off:a_off + m.ambient_size] = c
                cols.append(full)
            a_off += m.ambient_size
        return cols

    def batch_key(self):
        return ("Product",) + tuple(m.batch_key() for m in self.manifolds)


def _householder_vector(x):
    """The Householder vector v (v[-1] = 1) and beta with
    (I - beta v v') x = |x| e_last (householder_vector.h:48-82, Golub
    5.1.1 with the last element as pivot)."""
    sigma = torch.sum(x[:-1] * x[:-1])
    x_pivot = x[-1]
    trivial = sigma <= float(np.finfo(np.float64).eps)
    mu = torch.sqrt(x_pivot * x_pivot + torch.where(trivial, torch.zeros_like(sigma), sigma))
    v_pivot = torch.where(x_pivot <= 0.0, x_pivot - mu, -sigma / (x_pivot + mu))
    safe_v_pivot = torch.where(trivial, torch.ones_like(v_pivot), v_pivot)
    beta = torch.where(
        trivial,
        torch.where(x_pivot < 0.0, torch.full_like(sigma, 2.0), torch.zeros_like(sigma)),
        2.0 * safe_v_pivot * safe_v_pivot / (sigma + safe_v_pivot * safe_v_pivot))
    head = torch.where(trivial, x[:-1], x[:-1] / safe_v_pivot)
    return torch.cat([head, torch.ones_like(x[-1:])]), beta


def _exp_map_point(delta):
    """[sin(|d|)/|d| d; cos(|d|)], the point of the unit sphere at tangent
    delta from the pole e_last (1 and e_last at delta = 0)."""
    norm2 = torch.sum(delta * delta)
    pos = norm2 > 0
    safe = torch.sqrt(torch.where(pos, norm2, torch.ones_like(norm2)))
    one = torch.ones_like(norm2)
    sin_by = torch.where(pos, torch.sin(safe) / safe, one)
    return torch.cat([sin_by * delta, torch.where(pos, torch.cos(safe), one)[None]])


def _reflect(v, beta, y):
    """(I - beta v v') y."""
    return y - beta * v * torch.dot(v, y)


class SphereManifold(Manifold):
    """A vector on the (n-1)-sphere of radius |x| (sphere_manifold.h:86):
    the tangent step through the exponential map in x's Householder frame."""

    def __init__(self, size: int):
        if size < 2:
            raise ValueError("SphereManifold needs ambient size >= 2")
        self.ambient_size = size
        self.tangent_size = size - 1

    def plus(self, x, delta):
        v, beta = _householder_vector(x)
        return torch.sqrt(torch.sum(x * x)) * _reflect(v, beta, _exp_map_point(delta))

    def minus(self, y, x):
        v, beta = _householder_vector(x)
        nx = torch.sqrt(torch.sum(x * x))
        hy = _reflect(v, beta, y) / torch.where(nx > 0, nx, torch.ones_like(nx))
        u = hy[:-1]
        return _atan2_over_s(torch.sum(u * u), hy[-1]) * u

    def batch_key(self):
        return ("Sphere", self.ambient_size)


class LineManifold(Manifold):
    """A line in R^n as (origin, direction) (line_manifold.h:76), tangent
    2(n - 1): the origin moves in the hyperplane orthogonal to the
    direction, the direction on its sphere, both in the direction's
    Householder frame."""

    def __init__(self, n: int):
        if n < 2:
            raise ValueError("LineManifold needs spatial dim >= 2")
        self.n = n
        self.ambient_size = 2 * n
        self.tangent_size = 2 * (n - 1)

    def plus(self, x, delta):
        n = self.n
        origin, direction = x[:n], x[n:]
        v, beta = _householder_vector(direction)
        new_origin = origin + _reflect(v, beta, torch.cat([delta[:n - 1],
                                                           delta.new_zeros((1,))]))
        nd = torch.sqrt(torch.sum(direction * direction))
        new_direction = nd * _reflect(v, beta, _exp_map_point(delta[n - 1:]))
        return torch.cat([new_origin, new_direction])

    def minus(self, y, x):
        n = self.n
        v, beta = _householder_vector(x[n:])
        t_origin = _reflect(v, beta, y[:n] - x[:n])[:n - 1]
        ndx = torch.sqrt(torch.sum(x[n:] * x[n:]))
        hy = _reflect(v, beta, y[n:]) / torch.where(ndx > 0, ndx, torch.ones_like(ndx))
        u = hy[:-1]
        return torch.cat([t_origin, _atan2_over_s(torch.sum(u * u), hy[-1]) * u])

    def batch_key(self):
        return ("Line", self.n)


class AutoDiffManifold(Manifold):
    """A manifold of the user's plus and minus (autodiff_manifold.h): both
    plain torch functions of single blocks, traceable by torch.func; the
    Jacobians by forward-mode differentiation (Manifold.plus_jacobian)."""

    def __init__(self, plus_fn, minus_fn, ambient_size: int, tangent_size: int):
        self._plus = plus_fn
        self._minus = minus_fn
        self.ambient_size = ambient_size
        self.tangent_size = tangent_size

    def plus(self, x, delta):
        return self._plus(x, delta)

    def minus(self, y, x):
        return self._minus(y, x)

    def batch_key(self):
        return ("AutoDiff", id(self._plus), id(self._minus))
