"""Pose-graph SLAM in 2D and 3D (counterpart of
ceres_tpu/models/pose_graph.py; Ceres Solver's examples/slam/pose_graph_2d
and pose_graph_3d).

2D: each pose is three scalar blocks (x, y, yaw), the yaw on an angle
manifold (angle_manifold.h, an AutoDiffManifold), each edge the
information-weighted error of pose_graph_2d_error_term.h. 3D: each pose a
position (3) and an Eigen-order quaternion [x, y, z, w] on
EigenQuaternionManifold, each edge the SE3 error of
pose_graph_3d_error_term.h. The first pose is held constant. Both read
the g2o format (VERTEX_SE2 / EDGE_SE2, VERTEX_SE3:QUAT / EDGE_SE3:QUAT)
and make synthetic graphs from a seed (a circle, a helix, odometry edges
and random loop closures). The examples solve them with
SPARSE_NORMAL_CHOLESKY.
"""
from __future__ import annotations

import dataclasses
import math
import pathlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import rotation as rot
from ..cost_function import AutoDiffCostFunction
from ..manifolds import AutoDiffManifold, EigenQuaternionManifold
from ..problem import Problem


# --------------------------------------------------------------------------
# 2D
# --------------------------------------------------------------------------


def normalize_angle(a):
    """The angle in [-pi, pi) (pose_graph_2d/normalize_angle.h)."""
    return a - 2.0 * math.pi * torch.floor((a + math.pi) / (2.0 * math.pi))


def normalize_angle_np(a):
    return a - 2.0 * np.pi * np.floor((a + np.pi) / (2.0 * np.pi))


def angle_manifold() -> AutoDiffManifold:
    """SO(2) on a scalar angle (pose_graph_2d/angle_manifold.h)."""
    return AutoDiffManifold(lambda x, d: normalize_angle(x + d),
                            lambda y, x: normalize_angle(y - x), 1, 1)


def pose_graph_2d_residual(xa, ya, yawa, xb, yb, yawb, data):
    """sqrt_info [R_a'(p_b - p_a) - p_ab; normalize(yaw_b - yaw_a -
    yaw_ab)] (pose_graph_2d_error_term.h)."""
    p_ab, yaw_ab, sqrt_info = data
    c, s = torch.cos(yawa[0]), torch.sin(yawa[0])
    dx, dy = xb[0] - xa[0], yb[0] - ya[0]
    dp = torch.stack([c * dx + s * dy, -s * dx + c * dy])
    r = torch.cat([dp - p_ab, normalize_angle(yawb[0] - yawa[0] - yaw_ab)[None]])
    return sqrt_info @ r


POSE2D_COST = AutoDiffCostFunction(pose_graph_2d_residual, 3, [1, 1, 1, 1, 1, 1],
                                   name="pose2d")


@dataclasses.dataclass
class Pose2:
    x: float
    y: float
    yaw: float


@dataclasses.dataclass
class Constraint2:
    id_begin: int
    id_end: int
    x: float
    y: float
    yaw: float
    information: np.ndarray  # (3, 3)


def read_g2o_2d(path) -> Tuple[Dict[int, Pose2], List[Constraint2]]:
    """VERTEX_SE2 id x y yaw; EDGE_SE2 a b x y yaw and the upper triangle
    of the information matrix, row by row."""
    poses: Dict[int, Pose2] = {}
    constraints: List[Constraint2] = []
    for line in pathlib.Path(path).read_text().splitlines():
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "VERTEX_SE2":
            poses[int(tok[1])] = Pose2(float(tok[2]), float(tok[3]), float(tok[4]))
        elif tok[0] == "EDGE_SE2":
            x, y, yaw = (float(v) for v in tok[3:6])
            up = [float(v) for v in tok[6:12]]
            info = np.array([[up[0], up[1], up[2]], [up[1], up[3], up[4]],
                             [up[2], up[4], up[5]]])
            constraints.append(Constraint2(int(tok[1]), int(tok[2]), x, y, yaw, info))
    return poses, constraints


def build_problem_2d(poses: Dict[int, Pose2], constraints: List[Constraint2], loss=None):
    """pose_graph_2d.cc BuildOptimizationProblem: every yaw on the angle
    manifold, the first pose constant. Returns (problem, {id: (x, y, yaw)
    arrays of one value each}), the arrays the solve writes."""
    arrays = {pid: (np.array([p.x]), np.array([p.y]), np.array([p.yaw]))
              for pid, p in poses.items()}
    problem = Problem()
    am = angle_manifold()
    for pid in arrays:
        problem.add_parameter_block(arrays[pid][2], manifold=am)
    for c in constraints:
        xa, ya, yawa = arrays[c.id_begin]
        xb, yb, yawb = arrays[c.id_end]
        sqrt_info = np.linalg.cholesky(c.information).T
        problem.add_residual_block(POSE2D_COST, loss, [xa, ya, yawa, xb, yb, yawb],
                                   data=(np.array([c.x, c.y]), np.float64(c.yaw), sqrt_info))
    for arr in arrays[min(arrays)]:
        problem.set_parameter_block_constant(arr)
    return problem, arrays


def synthetic_2d(num_poses=100, loop_closures=8, noise=0.02, seed=0):
    """A circle of poses, noisy odometry edges and loop closures, the
    initial poses integrated from the odometry: (poses, constraints,
    ground truth)."""
    rng = np.random.default_rng(seed)
    R = 10.0
    gt = []
    for i in range(num_poses):
        th = 2 * np.pi * i / num_poses
        gt.append(Pose2(R * np.cos(th), R * np.sin(th), normalize_angle_np(th + np.pi / 2)))
    info = np.diag([100.0, 100.0, 400.0])

    def rel(a: Pose2, b: Pose2):
        c, s = np.cos(a.yaw), np.sin(a.yaw)
        dp = np.array([[c, s], [-s, c]]) @ np.array([b.x - a.x, b.y - a.y])
        return dp[0], dp[1], normalize_angle_np(b.yaw - a.yaw)

    def noisy(i, j):
        dx, dy, dth = rel(gt[i], gt[j])
        return Constraint2(i, j, dx + noise * rng.standard_normal(),
                           dy + noise * rng.standard_normal(),
                           dth + noise * rng.standard_normal(), info)

    constraints = [noisy(i, i + 1) for i in range(num_poses - 1)]
    for _ in range(loop_closures):
        i = int(rng.integers(0, num_poses))
        j = int(rng.integers(0, num_poses))
        if i != j:
            constraints.append(noisy(i, j))
    poses = {0: Pose2(gt[0].x, gt[0].y, gt[0].yaw)}
    for i in range(num_poses - 1):
        c, a = constraints[i], poses[i]
        ca, sa = np.cos(a.yaw), np.sin(a.yaw)
        poses[i + 1] = Pose2(a.x + ca * c.x - sa * c.y, a.y + sa * c.x + ca * c.y,
                             normalize_angle_np(a.yaw + c.yaw))
    return poses, constraints, gt


# --------------------------------------------------------------------------
# 3D
# --------------------------------------------------------------------------


def _w_first(q):
    return torch.cat([q[3:4], q[:3]])


def pose_graph_3d_residual(pa, qa, pb, qb, data):
    """sqrt_info [q_a^-1 (p_b - p_a) - p_ab; 2 vec(q_ab^-1 q_a^-1 q_b)]
    (pose_graph_3d_error_term.h), quaternions in Eigen order [x, y, z, w]."""
    p_ab, q_ab, sqrt_info = data
    qa_inv = rot.quaternion_conjugate(_w_first(qa))
    p_est = rot.unit_quaternion_rotate_point(qa_inv, pb - pa)
    q_ab_est = rot.quaternion_product(qa_inv, _w_first(qb))
    dq = rot.quaternion_product(rot.quaternion_conjugate(_w_first(q_ab)), q_ab_est)
    return sqrt_info @ torch.cat([p_est - p_ab, 2.0 * dq[1:]])


POSE3D_COST = AutoDiffCostFunction(pose_graph_3d_residual, 6, [3, 4, 3, 4], name="pose3d")


@dataclasses.dataclass
class Constraint3:
    id_begin: int
    id_end: int
    t: np.ndarray  # (3,)
    q: np.ndarray  # (4,) Eigen order [x, y, z, w]
    information: np.ndarray  # (6, 6)


def read_g2o_3d(path):
    """VERTEX_SE3:QUAT id x y z qx qy qz qw; EDGE_SE3:QUAT a b x y z qx qy
    qz qw and the upper triangle of the information matrix, row by row
    (pose_graph_3d/types.h)."""
    poses: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    constraints: List[Constraint3] = []
    iu = np.triu_indices(6)
    for line in pathlib.Path(path).read_text().splitlines():
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "VERTEX_SE3:QUAT":
            vals = np.array([float(v) for v in tok[2:9]])
            poses[int(tok[1])] = (vals[:3], vals[3:7])
        elif tok[0] == "EDGE_SE3:QUAT":
            vals = np.array([float(v) for v in tok[3:10]])
            info = np.zeros((6, 6))
            info[iu] = [float(v) for v in tok[10:31]]
            info = info + np.triu(info, 1).T
            constraints.append(Constraint3(int(tok[1]), int(tok[2]), vals[:3], vals[3:7],
                                           info))
    return poses, constraints


def build_problem_3d(poses, constraints, loss=None):
    """pose_graph_3d.cc BuildOptimizationProblem: every orientation on
    EigenQuaternionManifold, the first pose constant. Returns (problem,
    {id: (position (3,), quaternion (4,))})."""
    arrays = {pid: (np.ascontiguousarray(p, np.float64), np.ascontiguousarray(q, np.float64))
              for pid, (p, q) in poses.items()}
    problem = Problem()
    qm = EigenQuaternionManifold()
    for pid in arrays:
        problem.add_parameter_block(arrays[pid][1], manifold=qm)
    for c in constraints:
        pa, qa = arrays[c.id_begin]
        pb, qb = arrays[c.id_end]
        sqrt_info = np.linalg.cholesky(c.information).T
        problem.add_residual_block(POSE3D_COST, loss, [pa, qa, pb, qb],
                                   data=(c.t, c.q, sqrt_info))
    for arr in arrays[min(arrays)]:
        problem.set_parameter_block_constant(arr)
    return problem, arrays


def _np(fn, *args):
    """A rotation function of this package on float64 numpy arrays."""
    return fn(*(torch.as_tensor(np.asarray(a, np.float64)) for a in args)).numpy()


def _eigen(q_w):
    return np.concatenate([q_w[1:], q_w[:1]])


def _hamilton(q):
    return np.concatenate([q[3:4], q[:3]])


def synthetic_3d(num_poses=50, loop_closures=6, noise=0.01, seed=0):
    """A helix of poses, noisy odometry edges and loop closures, the
    initial poses integrated from the odometry: (poses, constraints,
    ground truth)."""
    rng = np.random.default_rng(seed)
    gt = []
    for i in range(num_poses):
        th = 4 * np.pi * i / num_poses
        pos = np.array([5 * np.cos(th), 5 * np.sin(th), 0.1 * i])
        gt.append((pos, _eigen(_np(rot.angle_axis_to_quaternion, [0.0, 0.0, th + np.pi / 2]))))
    info = np.diag([100.0] * 3 + [400.0] * 3)

    def rel(a, b):
        qa_inv = _np(rot.quaternion_conjugate, _hamilton(a[1]))
        dp = _np(rot.unit_quaternion_rotate_point, qa_inv, b[0] - a[0])
        return dp, _eigen(_np(rot.quaternion_product, qa_inv, _hamilton(b[1])))

    def noisy(dp, dq):
        dp = dp + noise * rng.standard_normal(3)
        nq = _np(rot.angle_axis_to_quaternion, noise * rng.standard_normal(3))
        return dp, _eigen(_np(rot.quaternion_product, _hamilton(dq), nq))

    constraints = []
    for i in range(num_poses - 1):
        constraints.append(Constraint3(i, i + 1, *noisy(*rel(gt[i], gt[i + 1])), info))
    for _ in range(loop_closures):
        i, j = rng.integers(0, num_poses, 2)
        if i != j:
            constraints.append(Constraint3(int(i), int(j),
                                           *noisy(*rel(gt[int(i)], gt[int(j)])), info))
    poses = {0: (gt[0][0].copy(), gt[0][1].copy())}
    for i in range(num_poses - 1):
        c = constraints[i]
        pa, qa = poses[i]
        p_new = pa + _np(rot.unit_quaternion_rotate_point, _hamilton(qa), c.t)
        q_new = _np(rot.quaternion_product, _hamilton(qa), _hamilton(c.q))
        poses[i + 1] = (p_new, _eigen(q_new / np.linalg.norm(q_new)))
    return poses, constraints, gt
