"""Bundle adjustment in the large (BAL) problems (counterpart of
ceres_tpu/models/bal.py).

Camera: 9 parameters, angle-axis rotation (3), translation (3), focal f,
radial distortion k1, k2. BAL convention: P = R X + t, p = -P / P_z,
predicted = f (1 + k1 r^2 + k2 r^4) p.

`synthetic_bal` and `perturb` draw the same numbers from the same seeds as
the JAX package (numpy's default_rng in the same order); the clean
observations come from the float64 torch residual, so they agree with the
JAX arrays to rounding, not bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cost_function import AutoDiffCostFunction
from ..problem import Problem
from ..rotation import angle_axis_rotate_point


def snavely_reprojection_residual(camera, point, observed):
    """SnavelyReprojectionError for one observation (branchy rotation)."""
    p = angle_axis_rotate_point(camera[:3], point) + camera[3:6]
    xp = -p[0] / p[2]
    yp = -p[1] / p[2]
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (camera[7] + camera[8] * r2)
    predicted_x = camera[6] * distortion * xp
    predicted_y = camera[6] * distortion * yp
    return torch.stack([predicted_x - observed[0], predicted_y - observed[1]])


def snavely_residual_rows(cam, pt, obs):
    """Row-vectorized Snavely residual: cam (9, rows), pt (3, rows), obs
    (2, rows) -> (2, rows); also takes single observations as (9,), (3,),
    (2,) vectors. Branch-free Rodrigues: theta = sqrt(theta2 + 1e-30)
    keeps the right theta -> 0 limit in every term, and differs from the
    branchy form only in O(theta^2) terms below sqrt(eps). The eval_fused
    CUDA kernel computes exactly this function (csrc/eval_fused.cu)."""
    ax, ay, az = cam[0:1], cam[1:2], cam[2:3]
    px, py, pz = pt[0:1], pt[1:2], pt[2:3]
    theta2 = ax * ax + ay * ay + az * az
    theta = torch.sqrt(theta2 + 1e-30)
    inv_t = 1.0 / theta
    wx, wy, wz = ax * inv_t, ay * inv_t, az * inv_t
    ct = torch.cos(theta)
    st = torch.sin(theta)
    cxx = wy * pz - wz * py
    cyy = wz * px - wx * pz
    czz = wx * py - wy * px
    wdp = wx * px + wy * py + wz * pz
    k = wdp * (1.0 - ct)
    rx = px * ct + cxx * st + wx * k + cam[3:4]
    ry = py * ct + cyy * st + wy * k + cam[4:5]
    rz = pz * ct + czz * st + wz * k + cam[5:6]
    xp = -rx / rz
    yp = -ry / rz
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (cam[7:8] + cam[8:9] * r2)
    f = cam[6:7]
    return torch.cat([f * distortion * xp - obs[0:1],
                      f * distortion * yp - obs[1:2]], dim=0)


SNAVELY_COST = AutoDiffCostFunction(
    snavely_reprojection_residual, 2, [9, 3], name="snavely")
# slot order in the cost is [camera, point]
SNAVELY_COST.residual_rows = snavely_residual_rows


@dataclasses.dataclass
class BALProblem:
    cameras: np.ndarray  # (num_cameras, 9)
    points: np.ndarray  # (num_points, 3)
    camera_index: np.ndarray  # (num_obs,)
    point_index: np.ndarray  # (num_obs,)
    observations: np.ndarray  # (num_obs, 2)

    @property
    def num_cameras(self):
        return self.cameras.shape[0]

    @property
    def num_points(self):
        return self.points.shape[0]

    @property
    def num_observations(self):
        return self.observations.shape[0]


def from_arrays(cameras, points, camera_index, point_index,
                observations) -> BALProblem:
    """The port's BALProblem from the arrays a BAL problem holds (the
    fields of ceres_tpu.models.bal.BALProblem), copied."""
    return BALProblem(
        np.array(cameras, dtype=np.float64),
        np.array(points, dtype=np.float64),
        np.array(camera_index, dtype=np.int32),
        np.array(point_index, dtype=np.int32),
        np.array(observations, dtype=np.float64),
    )


def synthetic_bal(num_cameras=16, num_points=500, visibility=0.3, noise=1.0,
                  seed=0) -> BALProblem:
    """Synthetic BA instance: cameras on a ring looking at a point cloud,
    observations from the ground truth plus pixel noise."""
    rng = np.random.default_rng(seed)
    cameras = np.zeros((num_cameras, 9))
    cameras[:, :3] = rng.standard_normal((num_cameras, 3)) * 0.1
    angles = np.linspace(0, 2 * np.pi, num_cameras, endpoint=False)
    cameras[:, 3] = 0.5 * np.cos(angles)
    cameras[:, 4] = 0.5 * np.sin(angles)
    cameras[:, 5] = 10.0 + rng.uniform(-0.5, 0.5, num_cameras)
    cameras[:, 6] = 500.0 + rng.uniform(-25, 25, num_cameras)
    cameras[:, 7] = rng.uniform(-1e-7, 1e-7, num_cameras)
    cameras[:, 8] = rng.uniform(-1e-13, 1e-13, num_cameras)
    points = rng.standard_normal((num_points, 3)) * 2.0

    seen = rng.random((num_points, num_cameras)) < visibility
    empty = ~seen.any(axis=1)
    if empty.any():
        seen[empty, rng.integers(0, num_cameras, int(empty.sum()))] = True
    pt_idx, cam_idx = np.nonzero(seen)
    cam_idx = cam_idx.astype(np.int32)
    pt_idx = pt_idx.astype(np.int32)

    cams_t = torch.as_tensor(cameras[cam_idx], dtype=torch.float64)
    pts_t = torch.as_tensor(points[pt_idx], dtype=torch.float64)
    zero = torch.zeros(2, dtype=torch.float64)
    obs_clean = torch.func.vmap(
        lambda c, p: snavely_reprojection_residual(c, p, zero))(cams_t, pts_t)
    obs = obs_clean.numpy() + noise * rng.standard_normal((len(cam_idx), 2))
    return BALProblem(cameras, points, cam_idx, pt_idx, obs)


def perturb(bal: BALProblem, rotation_sigma=0.0, translation_sigma=0.0,
            point_sigma=0.0, seed=1) -> BALProblem:
    """bal_problem.cc Perturb."""
    rng = np.random.default_rng(seed)
    cams = bal.cameras.copy()
    pts = bal.points.copy()
    cams[:, :3] += rotation_sigma * rng.standard_normal((bal.num_cameras, 3))
    cams[:, 3:6] += translation_sigma * rng.standard_normal((bal.num_cameras, 3))
    pts += point_sigma * rng.standard_normal(pts.shape)
    return BALProblem(cams, pts, bal.camera_index, bal.point_index,
                      bal.observations)


def build_problem_batched(bal: BALProblem, loss=None):
    """Parameter block arrays plus one batched residual add; returns
    (problem, camera_array, point_array). The solution is written back
    into the two returned (num_cameras, 9) / (num_points, 3) arrays."""
    cam_values = np.ascontiguousarray(bal.cameras)
    pt_values = np.ascontiguousarray(bal.points)
    p = Problem()
    cams = p.add_parameter_block_array(cam_values)
    pts = p.add_parameter_block_array(pt_values)
    p.add_residual_block_batch(
        SNAVELY_COST, loss,
        [(cams, bal.camera_index), (pts, bal.point_index)],
        data=bal.observations)
    return p, cam_values, pt_values


def bal16() -> BALProblem:
    """The BAL-16 problem: 16 cameras, 22,106 points, about 84k
    observations, perturbed from its ground truth (the instance whose
    float64 DENSE_SCHUR solve bench_golden.json records)."""
    n_cams, n_pts = 16, 22106
    vis = 83718 / (n_cams * n_pts)
    b = synthetic_bal(num_cameras=n_cams, num_points=n_pts, visibility=vis,
                      noise=1.0, seed=0)
    return perturb(b, rotation_sigma=0.02, translation_sigma=0.2,
                   point_sigma=0.2, seed=1)
