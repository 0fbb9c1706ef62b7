"""Camera intrinsics and view/projection matrix construction.

Row-vector convention throughout, matching the reference's tensors:
`world_view_transform` is W2C^T so points transform as `p_hom @ M`
(reference: src/gaussian_keyframe.cpp:151-184 computeTransformTensors,
cuda_rasterizer/auxiliary.h:59-78 transformPoint4x3/4x4).

Host-side math is numpy (tiny 4x4s built once per keyframe); everything the
render consumes is passed in as plain arrays.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def fov2focal(fov: float, pixels: int) -> float:
    """reference: include/graphics_utils.h:42-45"""
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: int) -> float:
    """reference: include/graphics_utils.h:47-50"""
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray,
                  trans: np.ndarray | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """World-to-camera 4x4 from rotation + translation, with the optional
    recenter/rescale detour through C2W.

    reference: src/gaussian_keyframe.cpp:230-249 getWorld2View2.
    """
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = C2W[:3, 3]
    if trans is not None:
        cam_center = cam_center + trans
    cam_center = cam_center * scale
    C2W[:3, 3] = cam_center
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """OpenGL-style perspective matrix (pre-transpose, i.e. column-vector form).

    reference: src/gaussian_keyframe.cpp:252-279 getProjectionMatrix.
    """
    tan_half_fovy = math.tan(fovy / 2.0)
    tan_half_fovx = math.tan(fovx / 2.0)
    top = tan_half_fovy * znear
    bottom = -top
    right = tan_half_fovx * znear
    left = -right

    P = np.zeros((4, 4), dtype=np.float32)
    z_sign = 1.0
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = z_sign
    P[2, 2] = z_sign * zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclasses.dataclass
class Camera:
    """Pinhole camera intrinsics (+ optional distortion, handled on host).

    reference: include/camera.h:30-139.
    """

    camera_id: int
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float
    # OpenCV-style distortion (k1 k2 p1 p2 k3); zeros = pre-undistorted input.
    dist_coeffs: tuple = (0.0, 0.0, 0.0, 0.0, 0.0)
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def fovx(self) -> float:
        return focal2fov(self.fx, self.width)

    @property
    def fovy(self) -> float:
        return focal2fov(self.fy, self.height)

    @property
    def tan_fovx(self) -> float:
        return math.tan(self.fovx * 0.5)

    @property
    def tan_fovy(self) -> float:
        return math.tan(self.fovy * 0.5)

    def projection(self) -> np.ndarray:
        return projection_matrix(self.znear, self.zfar, self.fovx, self.fovy)
