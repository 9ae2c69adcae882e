"""Bundle adjustment in the large (BAL) problems (counterpart of
ceres_tpu/models/bal.py).

Camera: 9 parameters, angle-axis rotation (3), translation (3), focal f,
radial distortion k1, k2. BAL convention: P = R X + t, p = -P / P_z,
predicted = f (1 + k1 r^2 + k2 r^4) p. The quaternion camera
(`SNAVELY_QUAT_COST`, `build_problem_batched_quat`; bundle_adjuster.cc's
--use_quaternions --use_manifolds) is the same model with a unit
quaternion in place of the angle-axis: 10 parameters under
ProductManifold(QuaternionManifold(), EuclideanManifold(6)), 9 tangent.

`synthetic_bal`, `synthetic_bal_large` and `perturb` draw the same numbers
from the same seeds as the JAX package (numpy's default_rng in the same
order); the clean
observations come from the float64 torch residual, so they agree with the
JAX arrays to rounding, not bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..cost_function import AutoDiffCostFunction
from ..loss import HuberLoss
from ..manifolds import EuclideanManifold, ProductManifold, QuaternionManifold
from ..problem import Problem
from ..rotation import (angle_axis_rotate_point, angle_axis_to_quaternion,
                        unit_quaternion_rotate_point)


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


def snavely_quat_residual(cam, pt, data):
    """Snavely reprojection with a unit-quaternion camera [q (w, x, y, z),
    t (3), f, k1, k2] (bal.py:86)."""
    p3 = unit_quaternion_rotate_point(cam[:4], pt) + cam[4:7]
    xp = -p3[0] / p3[2]
    yp = -p3[1] / p3[2]
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (cam[8] + cam[9] * r2)
    f = cam[7]
    return torch.stack([f * distortion * xp - data[0],
                        f * distortion * yp - data[1]])


def snavely_quat_residual_rows(cam, pt, obs):
    """Row-vectorized quaternion-camera Snavely residual: cam (10, rows),
    pt (3, rows), obs (2, rows) -> (2, rows), or single observations as
    vectors; the rotation in its two-cross-product form written lane by
    lane. The eval_fused CUDA kernel computes exactly this function
    (csrc/eval_fused.cu, model 1)."""
    w = cam[0:1]
    qx, qy, qz = cam[1:2], cam[2:3], cam[3:4]
    px, py, pz = pt[0:1], pt[1:2], pt[2:3]
    # uv = v x p; uuv = v x uv; p' = p + 2 (w uv + uuv)
    uvx = qy * pz - qz * py
    uvy = qz * px - qx * pz
    uvz = qx * py - qy * px
    uux = qy * uvz - qz * uvy
    uuy = qz * uvx - qx * uvz
    uuz = qx * uvy - qy * uvx
    rx = px + 2.0 * (w * uvx + uux) + cam[4:5]
    ry = py + 2.0 * (w * uvy + uuy) + cam[5:6]
    rz = pz + 2.0 * (w * uvz + uuz) + cam[6:7]
    xp = -rx / rz
    yp = -ry / rz
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (cam[8:9] + cam[9:10] * r2)
    f = cam[7:8]
    return torch.cat([f * distortion * xp - obs[0:1],
                      f * distortion * yp - obs[1:2]], dim=0)


SNAVELY_QUAT_COST = AutoDiffCostFunction(
    snavely_quat_residual, 2, [10, 3], name="snavely_quat")
SNAVELY_QUAT_COST.residual_rows = snavely_quat_residual_rows


def quaternion_camera_manifold():
    """The quaternion camera's manifold: the rotation on the unit sphere,
    the other six parameters Euclidean."""
    return ProductManifold(QuaternionManifold(), EuclideanManifold(6))


def cameras_to_quaternion(cameras: np.ndarray) -> np.ndarray:
    """(C, 9) angle-axis cameras -> (C, 10) unit-quaternion cameras."""
    q = angle_axis_to_quaternion(torch.as_tensor(cameras[:, :3], dtype=torch.float64))
    return np.concatenate([q.numpy(), cameras[:, 3:]], axis=1)


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

    obs = _clean_observations(cameras, points, cam_idx, pt_idx)
    obs += noise * rng.standard_normal((len(cam_idx), 2))
    return BALProblem(cameras, points, cam_idx, pt_idx, obs)


def _clean_observations(cameras, points, cam_idx, pt_idx, chunk=1 << 20):
    """The noise-free projections of every observation, float64 on the
    CPU, `chunk` rows at a time."""
    zero = torch.zeros(2, dtype=torch.float64)
    f = torch.func.vmap(lambda c, p: snavely_reprojection_residual(c, p, zero))
    B = cam_idx.shape[0]
    obs = np.empty((B, 2))
    for s in range(0, B, chunk):
        e = min(s + chunk, B)
        obs[s:e] = f(torch.as_tensor(cameras[cam_idx[s:e]]),
                     torch.as_tensor(points[pt_idx[s:e]])).numpy()
    return obs


def synthetic_bal_large(num_cameras=13696, num_points=1_000_000, mean_track=4.4,
                        cam_window=60, noise=1.0, seed=0) -> BALProblem:
    """Venice/Final-scale synthetic BA instance (the JAX package's BASELINE
    config 4 shape, ceres_tpu/models/bal.py:307) built without the (P, C)
    visibility matrix of synthetic_bal: each point draws a track length
    (geometric, at least 2) and samples its cameras from a window around an
    anchor camera, points ordered along the camera trajectory. O(B)
    memory; rows come sorted by point."""
    rng = np.random.default_rng(seed)
    C, P = num_cameras, num_points
    cameras = np.zeros((C, 9))
    cameras[:, :3] = rng.standard_normal((C, 3)) * 0.1
    angles = np.linspace(0, 2 * np.pi, C, endpoint=False)
    cameras[:, 3] = 0.5 * np.cos(angles)
    cameras[:, 4] = 0.5 * np.sin(angles)
    cameras[:, 5] = 10.0 + rng.uniform(-0.5, 0.5, C)
    cameras[:, 6] = 500.0 + rng.uniform(-25, 25, C)
    cameras[:, 7] = rng.uniform(-1e-7, 1e-7, C)
    cameras[:, 8] = rng.uniform(-1e-13, 1e-13, C)
    points = rng.standard_normal((P, 3)) * 2.0

    track = 2 + rng.geometric(1.0 / max(mean_track - 1.0, 1.0), P) - 1
    pt_idx = np.repeat(np.arange(P, dtype=np.int32), track)
    anchor = (pt_idx.astype(np.float64) / P * C).astype(np.int64)
    cam_idx = np.clip(
        anchor + rng.integers(-cam_window, cam_window + 1, pt_idx.shape[0]),
        0, C - 1).astype(np.int32)
    obs = _clean_observations(cameras, points, cam_idx, pt_idx)
    obs += noise * rng.standard_normal((cam_idx.shape[0], 2))
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


def read_bal_file(path) -> BALProblem:
    """The BAL text format (bal_problem.cc, bal.py:186-210): a header, the
    observations, then the parameters."""
    with open(path) as f:
        tokens = f.read().split()
    num_cameras, num_points, num_obs = (int(t) for t in tokens[:3])
    body = tokens[3:]
    obs = np.asarray(body[:4 * num_obs], dtype=np.float64).reshape(num_obs, 4)
    rest = np.asarray(body[4 * num_obs:4 * num_obs + 9 * num_cameras + 3 * num_points],
                      dtype=np.float64)
    return BALProblem(rest[:9 * num_cameras].reshape(num_cameras, 9),
                      rest[9 * num_cameras:].reshape(num_points, 3),
                      obs[:, 0].astype(np.int32), obs[:, 1].astype(np.int32),
                      np.ascontiguousarray(obs[:, 2:]))


def build_problem(bal: BALProblem, loss=None, use_huber=False):
    """A Problem built one block at a time, Ceres style (bal.py:266-284):
    one parameter block per camera and point, one residual block per
    observation. Returns (problem, camera blocks, point blocks), the
    (9,) and (3,) arrays the solution is written back into. For large
    problems build_problem_batched adds the same blocks without per-block
    Python."""
    cams = [np.ascontiguousarray(bal.cameras[i]) for i in range(bal.num_cameras)]
    pts = [np.ascontiguousarray(bal.points[j]) for j in range(bal.num_points)]
    if use_huber and loss is None:
        loss = HuberLoss(1.0)
    p = Problem()
    for k in range(bal.num_observations):
        p.add_residual_block(SNAVELY_COST, loss,
                             [cams[bal.camera_index[k]], pts[bal.point_index[k]]],
                             data=bal.observations[k])
    return p, cams, pts


def build_problem_batched(bal: BALProblem, loss=None, use_huber=False):
    """Parameter block arrays plus one batched residual add; returns
    (problem, camera_array, point_array). The solution is written back
    into the two returned (num_cameras, 9) / (num_points, 3) arrays.
    `use_huber` without a loss is bundle_adjuster.cc's --robustify,
    HuberLoss(1.0)."""
    if use_huber and loss is None:
        loss = HuberLoss(1.0)
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


def build_problem_batched_quat(bal: BALProblem, loss=None):
    """build_problem_batched with quaternion cameras under their manifold
    (bal.py:146); the solution is written back into the returned
    (num_cameras, 10) and (num_points, 3) arrays."""
    cam_values = cameras_to_quaternion(np.ascontiguousarray(bal.cameras))
    pt_values = np.ascontiguousarray(bal.points)
    p = Problem()
    cams = p.add_parameter_block_array(cam_values, manifold=quaternion_camera_manifold())
    pts = p.add_parameter_block_array(pt_values)
    p.add_residual_block_batch(
        SNAVELY_QUAT_COST, loss,
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
