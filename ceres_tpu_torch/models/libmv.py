"""libmv (Blender motion tracking) bundle adjustment (counterpart of
ceres_tpu/models/libmv.py, itself after Ceres' examples/
libmv_bundle_adjuster.cc).

The binary problem format: an endian marker, the markers' space flag, 8
shared camera intrinsics, cameras as (image, R, t), points as (track, X)
and markers as (image, track, x, y). The model refines cameras (angle-axis
and translation, 6), points (3) and the one shared intrinsics block (focal,
principal point, k1, k2, k3, p1, p2) under the polynomial and tangential
distortion model. Its cost carries no `residual_rows`, and it has two
camera-side families, so a solve takes the generic flat Schur path
(ops/flatops.FlatSchurOps), not the fused jt path of BAL.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np
import torch

from ..cost_function import AutoDiffCostFunction
from ..problem import Problem
from ..rotation import angle_axis_rotate_point, rotation_matrix_to_angle_axis

# intrinsics block layout (libmv_bundle_adjuster.cc OFFSET_*):
# focal, ppx, ppy, k1, k2, k3, p1, p2
INTRINSICS_SIZE = 8


@dataclasses.dataclass
class LibmvProblem:
    is_image_space: bool
    intrinsics: np.ndarray  # (8,)
    cameras: np.ndarray  # (n_cams, 6): angle-axis (3) + t (3)
    camera_images: np.ndarray  # original image numbers
    points: np.ndarray  # (n_pts, 3)
    point_tracks: np.ndarray
    marker_cam: np.ndarray  # (n_markers,) index into cameras
    marker_pt: np.ndarray  # (n_markers,) index into points
    markers: np.ndarray  # (n_markers, 2)


def read_libmv_file(path) -> LibmvProblem:
    """The binary problem file: endian marker 'v' (little) or 'V' (big);
    markers whose image or track is unknown are dropped."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[0:1] == b"v":
        endian = "<"
    elif data[0:1] == b"V":
        endian = ">"
    else:
        raise ValueError("unknown endian marker in libmv problem file")
    off = 1

    def read(fmt):
        nonlocal off
        vals = struct.unpack_from(endian + fmt, data, off)
        off += struct.calcsize(endian + fmt)
        return vals if len(vals) > 1 else vals[0]

    is_image_space = read("B") == ord("P")
    intrinsics = np.asarray(read("8f"), np.float64)
    cam_map, cams, images = {}, [], []
    for _ in range(read("i")):
        image = read("i")
        R = np.asarray(read("9f")).reshape(3, 3, order="F")  # column-major
        t = np.asarray(read("3f"))
        aa = rotation_matrix_to_angle_axis(torch.as_tensor(R, dtype=torch.float64))
        cam_map[image] = len(cams)
        cams.append(np.concatenate([aa.numpy(), t]))
        images.append(image)
    pt_map, pts, tracks = {}, [], []
    for _ in range(read("i")):
        track = read("i")
        pt_map[track] = len(pts)
        pts.append(np.asarray(read("3f")))
        tracks.append(track)
    mc, mp, mm = [], [], []
    for _ in range(read("i")):
        image, track = read("i"), read("i")
        xy = read("2f")
        if image in cam_map and track in pt_map:
            mc.append(cam_map[image])
            mp.append(pt_map[track])
            mm.append(xy)
    return LibmvProblem(
        is_image_space=is_image_space,
        intrinsics=intrinsics,
        cameras=np.asarray(cams, np.float64).reshape(-1, 6),
        camera_images=np.asarray(images),
        points=np.asarray(pts, np.float64).reshape(-1, 3),
        point_tracks=np.asarray(tracks),
        marker_cam=np.asarray(mc, np.int64),
        marker_pt=np.asarray(mp, np.int64),
        markers=np.asarray(mm, np.float64).reshape(-1, 2),
    )


def libmv_reprojection_residual(camera, point, intrinsics, observed):
    """Project, then apply the polynomial and tangential distortion
    (libmv_bundle_adjuster.cc ApplyDistortionModelUsingIntrinsicsBlock and
    OpenCVReprojectionError); one observation, under torch.func."""
    x = angle_axis_rotate_point(camera[:3], point) + camera[3:6]
    xn = x[0] / x[2]
    yn = x[1] / x[2]
    focal, ppx, ppy, k1, k2, k3, p1, p2 = (intrinsics[i] for i in range(8))
    r2 = xn * xn + yn * yn
    r4 = r2 * r2
    r6 = r4 * r2
    r_coeff = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    xd = xn * r_coeff + 2.0 * p1 * xn * yn + p2 * (r2 + 2.0 * xn * xn)
    yd = yn * r_coeff + 2.0 * p2 * xn * yn + p1 * (r2 + 2.0 * yn * yn)
    pred_x = focal * xd + ppx
    pred_y = focal * yd + ppy
    return torch.stack([pred_x - observed[0], pred_y - observed[1]])


LIBMV_COST = AutoDiffCostFunction(libmv_reprojection_residual, 2,
                                  [6, 3, INTRINSICS_SIZE], name="libmv")


def build_problem(lp: LibmvProblem, refine_intrinsics: Optional[bool] = None):
    """BuildProblem: cameras, points and the shared intrinsics as three
    parameter block arrays, the markers as one batched add. Returns
    (problem, cameras (n, 6), points (n, 3), intrinsics (1, 8)), the arrays
    the solution is written back into. refine_intrinsics defaults to the
    markers' space, as the example's flags do: image-space markers refine
    the intrinsics, normalized ones hold them constant (libmv.py:126-160)."""
    if refine_intrinsics is None:
        refine_intrinsics = lp.is_image_space
    cams = np.ascontiguousarray(lp.cameras, dtype=np.float64)
    pts = np.ascontiguousarray(lp.points, dtype=np.float64)
    intr = np.array(lp.intrinsics, dtype=np.float64).reshape(1, INTRINSICS_SIZE)
    p = Problem()
    cam_arr = p.add_parameter_block_array(cams)
    pt_arr = p.add_parameter_block_array(pts)
    intr_arr = p.add_parameter_block_array(intr)
    if not refine_intrinsics:
        p.set_parameter_block_array_constant(intr_arr)
    zeros = np.zeros(len(lp.marker_cam), np.int64)
    p.add_residual_block_batch(
        LIBMV_COST, None,
        [(cam_arr, lp.marker_cam), (pt_arr, lp.marker_pt), (intr_arr, zeros)],
        data=lp.markers)
    return p, cams, pts, intr
