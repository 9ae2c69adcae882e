"""Angle-axis rotation of points (counterpart of ceres_tpu/rotation.py).

`angle_axis_rotate_point` (rotation.h AngleAxisRotatePoint), the rotation
the Snavely and libmv camera models use, with its small-angle branch; it
works on a trailing axis of 3, under torch.func transforms. And
`rotation_matrix_to_angle_axis`, which the libmv file reader needs.
"""
from __future__ import annotations

import torch


def _safe_sqrt_sum_sq(v):
    s = torch.sum(v * v, dim=-1, keepdim=True)
    # sqrt'(0) is inf; the caller's branch keeps that value out of the result
    safe = torch.where(s > 0.0, s, torch.ones_like(s))
    return torch.sqrt(safe), s


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
