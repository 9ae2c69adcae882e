"""Angle-axis rotation of points (counterpart of ceres_tpu/rotation.py).

Only `angle_axis_rotate_point` (rotation.h AngleAxisRotatePoint), the
rotation the Snavely camera model uses, with its small-angle branch. Works
on a trailing axis of 3, under torch.func transforms.
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
