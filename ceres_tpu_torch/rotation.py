"""Rotation conversions (counterpart of ceres_tpu/rotation.py).

Every function works on trailing axes (3 for angle-axis and points, 4 for
quaternions, (3, 3) for matrices) under torch.func transforms; the
small-angle branches keep their derivatives finite at the branch point.
Quaternions are Hamilton, w first: [w, x, y, z] (as rotation.h). The
Snavely and libmv camera models rotate by `angle_axis_rotate_point`, the
quaternion-camera model by `unit_quaternion_rotate_point`; the libmv
reader needs `rotation_matrix_to_angle_axis`.
"""
from __future__ import annotations

import torch


def _safe_sqrt_sum_sq(v):
    s = torch.sum(v * v, dim=-1, keepdim=True)
    # sqrt'(0) is inf; the caller's branch keeps that value out of the result
    safe = torch.where(s > 0.0, s, torch.ones_like(s))
    return torch.sqrt(safe), s


def angle_axis_to_quaternion(angle_axis: torch.Tensor) -> torch.Tensor:
    """rotation.h AngleAxisToQuaternion."""
    theta, theta2 = _safe_sqrt_sum_sq(angle_axis)
    small = theta2 <= torch.finfo(angle_axis.dtype).eps
    half = 0.5 * theta
    k = torch.where(small, torch.full_like(theta, 0.5), torch.sin(half) / theta)
    w = torch.where(small[..., 0], torch.ones_like(theta[..., 0]),
                    torch.cos(half)[..., 0])
    return torch.cat([w[..., None], angle_axis * k], dim=-1)


def quaternion_product(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rotation.h QuaternionProduct: z w."""
    z0, z1, z2, z3 = z[..., 0], z[..., 1], z[..., 2], z[..., 3]
    w0, w1, w2, w3 = w[..., 0], w[..., 1], w[..., 2], w[..., 3]
    return torch.stack([
        z0 * w0 - z1 * w1 - z2 * w2 - z3 * w3,
        z0 * w1 + z1 * w0 + z2 * w3 - z3 * w2,
        z0 * w2 - z1 * w3 + z2 * w0 + z3 * w1,
        z0 * w3 + z1 * w2 - z2 * w1 + z3 * w0,
    ], dim=-1)


def quaternion_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def unit_quaternion_rotate_point(q: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    """rotation.h UnitQuaternionRotatePoint, in its two-cross-product form:
    p + 2 (w (v x p) + v x (v x p))."""
    w = q[..., :1]
    v = q[..., 1:]
    uv = torch.linalg.cross(v, pt, dim=-1)
    uuv = torch.linalg.cross(v, uv, dim=-1)
    return pt + 2.0 * (w * uv + uuv)


def _normalized(q: torch.Tensor) -> torch.Tensor:
    n = torch.sum(q * q, dim=-1, keepdim=True)
    return q * torch.rsqrt(torch.where(n > 0, n, torch.ones_like(n)))


def quaternion_rotate_point(q: torch.Tensor, pt: torch.Tensor) -> torch.Tensor:
    """rotation.h QuaternionRotatePoint (normalizes first)."""
    return unit_quaternion_rotate_point(_normalized(q), pt)


def unit_quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """rotation.h QuaternionToScaledRotation for a unit quaternion."""
    a, b, c, d = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    aa, ab, ac, ad = a * a, a * b, a * c, a * d
    bb, bc, bd = b * b, b * c, b * d
    cc, cd = c * c, c * d
    dd = d * d
    return torch.stack([
        torch.stack([aa + bb - cc - dd, 2 * (bc - ad), 2 * (ac + bd)], dim=-1),
        torch.stack([2 * (ad + bc), aa - bb + cc - dd, 2 * (cd - ab)], dim=-1),
        torch.stack([2 * (bd - ac), 2 * (ab + cd), aa - bb - cc + dd], dim=-1),
    ], dim=-2)


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """rotation.h QuaternionToRotation (normalizes first)."""
    return unit_quaternion_to_rotation_matrix(_normalized(q))


def angle_axis_rotate_point(angle_axis: torch.Tensor,
                            pt: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula on a point; first order below theta^2 <= eps."""
    theta, theta2 = _safe_sqrt_sum_sq(angle_axis)
    eps = torch.finfo(angle_axis.dtype).eps
    small = theta2[..., 0] <= eps
    w = angle_axis / torch.where(theta2 > eps, theta, torch.ones_like(theta))
    ct = torch.cos(theta)
    st = torch.sin(theta)
    w_cross_pt = torch.linalg.cross(w, pt, dim=-1)
    w_dot_pt = torch.sum(w * pt, dim=-1, keepdim=True)
    big = pt * ct + w_cross_pt * st + w * (w_dot_pt * (1.0 - ct))
    small_val = pt + torch.linalg.cross(angle_axis, pt, dim=-1)
    return torch.where(small[..., None], small_val, big)


def rotation_matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """rotation.h RotationMatrixToQuaternion: (..., 3, 3) -> [w, x, y, z],
    taking the best conditioned of the four classic formulas."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def case(d, parts):
        t = torch.sqrt(torch.clamp(d, min=1e-30))
        s = 0.5 / t
        return torch.stack([0.5 * t if p is None else p * s for p in parts], -1)

    qw = case(1.0 + tr, [None, m21 - m12, m02 - m20, m10 - m01])
    qx = case(1.0 + m00 - m11 - m22, [m21 - m12, None, m01 + m10, m02 + m20])
    qy = case(1.0 - m00 + m11 - m22, [m02 - m20, m01 + m10, None, m12 + m21])
    qz = case(1.0 - m00 - m11 + m22, [m10 - m01, m02 + m20, m12 + m21, None])
    x_best = (m00 >= m11) & (m00 >= m22)
    y_best = ~x_best & (m11 >= m22)
    q = torch.where(x_best[..., None], qx, torch.where(y_best[..., None], qy, qz))
    return torch.where((tr > 0.0)[..., None], qw, q)


def quaternion_to_angle_axis(q: torch.Tensor) -> torch.Tensor:
    """rotation.h QuaternionToAngleAxis, the shortest representation."""
    q1, q2, q3 = q[..., 1], q[..., 2], q[..., 3]
    sin2 = q1 * q1 + q2 * q2 + q3 * q3
    small = sin2 <= torch.finfo(q.dtype).eps
    sin_theta = torch.sqrt(torch.where(small, torch.ones_like(sin2), sin2))
    cos_theta = q[..., 0]
    two_theta = 2.0 * torch.where(cos_theta < 0.0,
                                  torch.atan2(-sin_theta, -cos_theta),
                                  torch.atan2(sin_theta, cos_theta))
    k = torch.where(small, torch.full_like(sin2, 2.0), two_theta / sin_theta)
    return torch.stack([q1 * k, q2 * k, q3 * k], dim=-1)


def rotation_matrix_to_angle_axis(R: torch.Tensor) -> torch.Tensor:
    return quaternion_to_angle_axis(rotation_matrix_to_quaternion(R))
