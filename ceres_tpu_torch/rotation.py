"""Rotation conversions (counterpart of ceres_tpu/rotation.py).

Every function works on trailing axes (3 for angle-axis and points, 4 for
quaternions, (3, 3) for matrices) under torch.func transforms; the
small-angle branches keep their derivatives finite at the branch point.
Quaternions are Hamilton, w first: [w, x, y, z] (as rotation.h). The
Snavely and libmv camera models rotate by `angle_axis_rotate_point`, the
quaternion-camera model by `unit_quaternion_rotate_point`; the libmv
reader needs `rotation_matrix_to_angle_axis`. Users' cost functions also
get the Rodrigues matrix, the cross-product matrix and Euler angles in
degrees (rotation.h's legacy helper) or in any of the 24 conventions.
"""
from __future__ import annotations

import math

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


def angle_axis_to_rotation_matrix(angle_axis: torch.Tensor) -> torch.Tensor:
    """rotation.h AngleAxisToRotationMatrix (Rodrigues); below theta^2 <= eps
    the first-order R = I + [w]_x, as the reference's small branch."""
    theta, theta2 = _safe_sqrt_sum_sq(angle_axis)
    eps = torch.finfo(angle_axis.dtype).eps
    small = theta2[..., 0] <= eps
    axis = angle_axis / torch.where(theta2 > eps, theta, torch.ones_like(theta))
    wx, wy, wz = axis[..., 0], axis[..., 1], axis[..., 2]
    ct = torch.cos(theta[..., 0])
    st = torch.sin(theta[..., 0])
    one_ct = 1.0 - ct
    R_big = torch.stack([
        torch.stack([ct + wx * wx * one_ct, wx * wy * one_ct - wz * st,
                     wy * st + wx * wz * one_ct], -1),
        torch.stack([wz * st + wx * wy * one_ct, ct + wy * wy * one_ct,
                     -wx * st + wy * wz * one_ct], -1),
        torch.stack([-wy * st + wx * wz * one_ct, wx * st + wy * wz * one_ct,
                     ct + wz * wz * one_ct], -1),
    ], -2)
    ax, ay, az = angle_axis[..., 0], angle_axis[..., 1], angle_axis[..., 2]
    one = torch.ones_like(ax)
    R_small = torch.stack([
        torch.stack([one, -az, ay], -1),
        torch.stack([az, one, -ax], -1),
        torch.stack([-ay, ax, one], -1),
    ], -2)
    return torch.where(small[..., None, None], R_small, R_big)


def euler_angles_to_rotation_matrix(euler_deg: torch.Tensor) -> torch.Tensor:
    """rotation.h EulerAnglesToRotationMatrix: three angles in degrees,
    composed about Z, Y and X in the reference's layout."""
    rad = euler_deg * (math.pi / 180.0)
    c = torch.cos(rad)
    s = torch.sin(rad)
    c1, c2, c3 = c[..., 0], c[..., 1], c[..., 2]
    s1, s2, s3 = s[..., 0], s[..., 1], s[..., 2]
    return torch.stack([
        torch.stack([c1 * c2, -s1 * c3 + c1 * s2 * s3, s1 * s3 + c1 * s2 * c3], -1),
        torch.stack([s1 * c2, c1 * c3 + s1 * s2 * s3, -c1 * s3 + s1 * s2 * c3], -1),
        torch.stack([-s2, c2 * s3, c2 * c3], -1),
    ], -2)


def cross_product_matrix(v: torch.Tensor) -> torch.Tensor:
    """[v]_x, the skew-symmetric matrix of v x ."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


# Generalized Euler angles (rotation.h:214-353 EulerAnglesToRotation /
# RotationMatrixToEulerAngles over euler_angles.h's 24 EulerSystem tags):
# conventions "IntrinsicZYX", "ExtrinsicXYX", ...; angles in radians,
# ordered by the axis sequence.

_EULER_AXES = {"X": 0, "Y": 1, "Z": 2}


def _parse_euler_convention(convention: str):
    c = convention.strip()
    if c.startswith("Intrinsic"):
        intrinsic, seq = True, c[len("Intrinsic"):]
    elif c.startswith("Extrinsic"):
        intrinsic, seq = False, c[len("Extrinsic"):]
    else:
        raise ValueError(f"convention must start with Intrinsic/Extrinsic: {convention}")
    if len(seq) != 3 or any(a not in _EULER_AXES for a in seq):
        raise ValueError(f"bad axis sequence {seq!r}")
    axes = tuple(_EULER_AXES[a] for a in seq)
    if axes[0] == axes[1] or axes[1] == axes[2]:
        raise ValueError(f"consecutive axes must differ: {seq!r}")
    return intrinsic, axes


def _axis_rotation(axis: int, theta: torch.Tensor) -> torch.Tensor:
    """The (3, 3) rotation by theta about one coordinate axis."""
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(theta), torch.zeros_like(theta)
    i, j = (axis + 1) % 3, (axis + 2) % 3
    R = [[zero] * 3 for _ in range(3)]
    R[axis][axis] = one
    R[i][i], R[j][j] = c, c
    R[i][j], R[j][i] = -s, s
    return torch.stack([torch.stack(row) for row in R])


def _is_even(i, j, k):
    return (i, j, k) in ((0, 1, 2), (1, 2, 0), (2, 0, 1))


def _as_float(a) -> torch.Tensor:
    a = torch.as_tensor(a)
    return a if a.is_floating_point() else a.to(torch.float64)


def euler_angles_to_rotation(convention: str, angles) -> torch.Tensor:
    """The rotation matrix of any of the 24 Euler conventions
    (EulerAnglesToRotation, rotation.h:221). Intrinsic sequences rotate in
    the body frame (R = R_a1(t1) R_a2(t2) R_a3(t3)), extrinsic ones in the
    global frame (R = R_a3(t3) R_a2(t2) R_a1(t1))."""
    intrinsic, (a1, a2, a3) = _parse_euler_convention(convention)
    angles = _as_float(angles)
    t1, t2, t3 = angles[0], angles[1], angles[2]
    if intrinsic:
        return _axis_rotation(a1, t1) @ _axis_rotation(a2, t2) @ _axis_rotation(a3, t3)
    return _axis_rotation(a3, t3) @ _axis_rotation(a2, t2) @ _axis_rotation(a1, t1)


def rotation_matrix_to_euler_angles(convention: str, R) -> torch.Tensor:
    """The inverse of euler_angles_to_rotation (RotationMatrixToEulerAngles,
    rotation.h:253): Tait-Bryan angles by the Shoemake index formulas,
    proper Euler angles (first axis repeated last) by the arccos
    mid-angle branch."""
    intrinsic, axes = _parse_euler_convention(convention)
    R = _as_float(R)
    if not intrinsic:  # Extrinsic(a1 a2 a3)(t1, t2, t3) == Intrinsic(a3 a2 a1)(t3, t2, t1)
        i, j, k = axes[2], axes[1], axes[0]
    else:
        i, j, k = axes
    if i != k:  # Tait-Bryan
        e = 1.0 if _is_even(i, j, k) else -1.0
        t2 = torch.arcsin(torch.clamp(e * R[i, k], -1.0, 1.0))
        t1 = torch.atan2(-e * R[j, k], R[k, k])
        t3 = torch.atan2(-e * R[i, j], R[i, i])
    else:  # proper Euler: i == k, free axis l
        l = 3 - i - j
        e = 1.0 if _is_even(i, j, l) else -1.0
        t2 = torch.arccos(torch.clamp(R[i, i], -1.0, 1.0))
        t1 = torch.atan2(R[j, i], -e * R[l, i])
        t3 = torch.atan2(R[i, j], e * R[i, l])
    out = torch.stack([t1, t2, t3])
    return out if intrinsic else out.flip(0)


EULER_CONVENTIONS = tuple(
    f"{frame}{a}{b}{c}"
    for frame in ("Intrinsic", "Extrinsic")
    for a in "XYZ" for b in "XYZ" for c in "XYZ"
    if a != b and b != c
)
