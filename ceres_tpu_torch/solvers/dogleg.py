"""The dogleg strategy of the host loop, TRADITIONAL and SUBSPACE
(counterpart of ceres_tpu/solvers/dogleg.py:36; dogleg_strategy.cc).

Kept from the reference: the elliptical trust region through
D = sqrt(clamp(diag(J'J))); the Gauss-Newton point solved at the LM
diagonal mu D^2, mu raised tenfold while it is not finite and halved back
(to a floor) on acceptance; the Cauchy point alpha = |g|^2 / |J D^-1 g|^2;
the traditional piecewise path; the subspace dogleg's exact 2-D boundary
problem through the quartic of
MakePolynomialForBoundaryConstrainedProblem (:418-440) and its cosine
check, falling back to the traditional step; the radius rules.

The kernels object's own step (`compute_step`) solves for the
Gauss-Newton point, so the strategy runs on every host-loop tier: the
dense solvers, DENSE_SCHUR, ITERATIVE_SCHUR and CGNR. The vector work
stays on the device; the 2-D algebra and the root finding run on the host
on the two vectors g and the Gauss-Newton point, fetched once per new
evaluation point.
"""
from __future__ import annotations

import numpy as np
import torch

from ..options import Options
from ..types import DoglegType, LinearSolverTerminationType
from ..utils.polynomial import find_polynomial_roots
from .trust_region import StepResult

_K_MIN_MU = 1e-8
_K_MAX_MU = 1.0


class DoglegStrategy:
    """The alternative to LevenbergMarquardtStrategy, with its interface."""

    def __init__(self, options: Options):
        self.radius = options.initial_trust_region_radius
        self.max_radius = options.max_trust_region_radius
        self.dogleg_type = options.dogleg_type
        self.mu = _K_MIN_MU
        self.increase_threshold = 0.75
        self.decrease_threshold = 0.25
        self.reuse = False
        self._dogleg_step_norm = 0.0

    def _gradient_alpha(self, m, ds):
        """(g = D^-1 J'r, its Cauchy alpha) on the device."""
        g = m.k.left_multiply(m.jacobian, m.residuals) / ds
        jg = m.k.right_multiply(m.jacobian, g / ds)
        return g, torch.sum(g * g) / torch.sum(jg * jg)

    def _gauss_newton(self, m, ds):
        """The Gauss-Newton point in the scaled space, mu x10 while it is
        not finite (ComputeGaussNewtonStep, :520-568); None past mu = 1."""
        ones = torch.ones_like(ds)
        while self.mu < _K_MAX_MU:
            # the kernels' step at scale 1 and radius 1: D_lm = D sqrt(mu)
            step, _, _, _ = m.k.compute_step(m.jacobian, m.residuals, ones,
                                             ds * ds * self.mu, 1.0, m.fetch)
            (ok,) = m.fetch(torch.isfinite(step).all())
            if ok != 0.0:
                return step * ds
            self.mu *= 10.0
        return None

    def compute_step(self, m) -> StepResult:
        if not self.reuse:
            diag = m.k.lm_diagonal(m.jacobian, torch.ones(
                m.program.tangent_size, dtype=torch.float64, device=m.x.device))
            self._diag_sqrt = torch.sqrt(diag)
            g, alpha = self._gradient_alpha(m, self._diag_sqrt)
            gn = self._gauss_newton(m, self._diag_sqrt)
            if gn is None:
                return StepResult(termination=LinearSolverTerminationType.FAILURE)
            self._g, self._gn = m.to_host(g, gn)
            (self._alpha,) = m.fetch(alpha)
        self.reuse = True

        if self.dogleg_type == DoglegType.TRADITIONAL_DOGLEG:
            step_scaled = self._traditional()
        else:
            step_scaled = self._subspace(m)
        # back to the tangent coordinates: the ellipse replaces Jacobi scaling
        ds = self._diag_sqrt
        step = torch.as_tensor(step_scaled, device=ds.device) / ds
        jstep = m.k.right_multiply(m.jacobian, step)
        (mcc,) = m.fetch(-torch.dot(jstep, m.residuals + jstep / 2.0))
        if not np.isfinite(mcc):
            return StepResult(termination=LinearSolverTerminationType.FAILURE)
        return StepResult(delta=step, model_cost_change=mcc,
                          termination=LinearSolverTerminationType.SUCCESS)

    # ---- geometry, on the host ---------------------------------------------

    def _traditional(self) -> np.ndarray:
        g, gn = self._g, self._gn
        radius = self.radius
        gnorm = np.linalg.norm(g)
        gn_norm = np.linalg.norm(gn)
        if gn_norm <= radius:
            self._dogleg_step_norm = gn_norm
            return gn
        if gnorm * self._alpha >= radius:
            self._dogleg_step_norm = radius
            return -(radius / gnorm) * g
        a_dot_b = -self._alpha * float(g @ gn)
        a2 = (self._alpha * gnorm) ** 2
        b_minus_a2 = a2 - 2 * a_dot_b + gn_norm ** 2
        c = a_dot_b - a2
        d = np.sqrt(c * c + b_minus_a2 * (radius ** 2 - a2))
        beta = (d - c) / b_minus_a2 if c <= 0 else (radius ** 2 - a2) / (d + c)
        step = (-self._alpha * (1.0 - beta)) * g + beta * gn
        self._dogleg_step_norm = float(np.linalg.norm(step))
        return step

    def _subspace(self, m) -> np.ndarray:
        g, gn = self._g, self._gn
        radius = self.radius
        gn_norm = np.linalg.norm(gn)
        if gn_norm <= radius:
            self._dogleg_step_norm = gn_norm
            return gn
        q, r = _colpiv_qr(np.stack([g, gn], axis=1))
        rank = int(np.sum(np.abs(np.diag(r)) > 1e-14 * max(1.0, abs(r[0, 0]))))
        if rank <= 1:
            self._dogleg_step_norm = radius
            return -(radius / np.linalg.norm(g)) * g
        U = q[:, :2]  # an orthonormal basis of the plane of g and gn
        sg = U.T @ g
        # B = (J D^-1 U)'(J D^-1 U)
        ds = self._diag_sqrt
        Jb = np.stack(m.to_host(*[
            m.k.right_multiply(m.jacobian, torch.as_tensor(U[:, i], device=ds.device) / ds)
            for i in range(2)]), axis=0)
        B = Jb @ Jb.T
        minimum = self._find_minimum_on_boundary(B, sg, radius)
        if minimum is None:
            return self._traditional()
        grad_min = B @ minimum + sg
        denom = np.linalg.norm(minimum) * np.linalg.norm(grad_min)
        cosine = -float(minimum @ grad_min) / denom if denom > 0 else 1.0
        if cosine < 0.99:
            return self._traditional()
        self._dogleg_step_norm = radius
        return U @ minimum

    @staticmethod
    def _find_minimum_on_boundary(B, g2, radius):
        """The minimizer of 1/2 x'Bx + g2'x on |x| = radius among the real
        roots of the Lagrange quartic (:418-440), or None."""
        detB = float(np.linalg.det(B))
        trB = float(np.trace(B))
        r2 = radius * radius
        B_adj = np.array([[B[1, 1], -B[0, 1]], [-B[1, 0], B[0, 0]]])
        poly = np.array([
            r2,
            2.0 * r2 * trB,
            r2 * (trB * trB + 2.0 * detB) - float(g2 @ g2),
            -2.0 * (float(g2 @ B_adj @ g2) - r2 * detB * trB),
            r2 * detB * detB - float((B_adj @ g2) @ (B_adj @ g2)),
        ])
        try:
            roots_real, _ = find_polynomial_roots(poly)
        except (ValueError, np.linalg.LinAlgError):
            return None
        best, best_val = None, np.inf
        for y in roots_real:
            try:
                x = -np.linalg.solve(B + y * np.eye(2), g2)
            except np.linalg.LinAlgError:
                continue
            nx = np.linalg.norm(x)
            if nx > 0:
                xb = (radius / nx) * x
                f = 0.5 * float(xb @ B @ xb) + float(g2 @ xb)
                if f < best_val:
                    best_val, best = f, x
        return best

    # ---- the radius and mu ---------------------------------------------------

    def step_accepted(self, step_quality: float):
        assert step_quality > 0.0
        if step_quality < self.decrease_threshold:
            self.radius *= 0.5
        if step_quality > self.increase_threshold:
            self.radius = max(self.radius, 3.0 * self._dogleg_step_norm)
        self.radius = min(self.radius, self.max_radius)
        self.mu = max(_K_MIN_MU, 2.0 * self.mu / 10.0)
        self.reuse = False

    def step_rejected(self, step_quality: float):
        self.radius *= 0.5
        self.reuse = True

    def step_is_invalid(self):
        self.mu *= 10.0
        self.reuse = False


def _colpiv_qr(A: np.ndarray):
    """(Q, R) of the column-pivoted QR of A (scipy), numpy's unpivoted QR
    without scipy."""
    try:
        import scipy.linalg as sl
    except ImportError:
        return np.linalg.qr(A)
    q, r, _ = sl.qr(A, pivoting=True, mode="economic")
    return q, r
