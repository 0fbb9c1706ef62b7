"""Camera undistortion: rectify maps + undistort masks, host-side numpy.

Replaces the reference's OpenCV initUndistortRectifyMap / remap plumbing and
the white-image undistort mask (reference: Camera::initUndistortRectifyMap-
AndMask, include/camera.h:76-113; cv::remap of an all-white image produces
the valid-pixel mask used to gate the photometric loss).

Model: OpenCV radial-tangential (k1, k2, p1, p2, k3). The map is built once
per camera (forward-distortion evaluated at every target pixel); application
is a bilinear gather — numpy at keyframe rate.

Copy of segs_slam_tpu/core/undistort.py with the port's torch `se3`.
"""

from __future__ import annotations

import numpy as np
import torch

from segs_slam_tpu_torch.core import se3
from segs_slam_tpu_torch.core.camera import Camera


def _bilinear_remap(image: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
                    mask: np.ndarray) -> np.ndarray:
    """Bilinear gather of (H, W) or (H, W, C) images at (map_y, map_x)."""
    h, w = image.shape[:2]
    x0 = np.clip(np.floor(map_x).astype(int), 0, w - 1)
    y0 = np.clip(np.floor(map_y).astype(int), 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    fx = np.clip(map_x - x0, 0, 1)
    fy = np.clip(map_y - y0, 0, 1)
    img = image[..., None] if image.ndim == 2 else image
    out = (
        img[y0, x0] * ((1 - fx) * (1 - fy))[..., None]
        + img[y0, x1] * (fx * (1 - fy))[..., None]
        + img[y1, x0] * ((1 - fx) * fy)[..., None]
        + img[y1, x1] * (fx * fy)[..., None]
    )
    out = out * mask[..., None]
    return out[..., 0] if image.ndim == 2 else out


class UndistortMap:
    def __init__(self, camera: Camera):
        self.camera = camera
        k1, k2, p1, p2, k3 = camera.dist_coeffs
        h, w = camera.height, camera.width
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        # normalized coords in the ideal (undistorted) camera
        x = (xs - camera.cx) / camera.fx
        y = (ys - camera.cy) / camera.fy
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        x_d = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        y_d = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        self.map_x = (x_d * camera.fx + camera.cx).astype(np.float32)
        self.map_y = (y_d * camera.fy + camera.cy).astype(np.float32)
        self.mask = (
            (self.map_x >= 0)
            & (self.map_x <= w - 1)
            & (self.map_y >= 0)
            & (self.map_y <= h - 1)
        ).astype(np.float32)

    @property
    def is_identity(self) -> bool:
        return not any(self.camera.dist_coeffs)

    def remap(self, image: np.ndarray) -> np.ndarray:
        """Bilinear remap of (H, W) or (H, W, C) images."""
        if self.is_identity:
            return image
        h, w = self.map_x.shape
        x0 = np.clip(np.floor(self.map_x).astype(int), 0, w - 1)
        y0 = np.clip(np.floor(self.map_y).astype(int), 0, h - 1)
        x1 = np.clip(x0 + 1, 0, w - 1)
        y1 = np.clip(y0 + 1, 0, h - 1)
        fx = np.clip(self.map_x - x0, 0, 1)
        fy = np.clip(self.map_y - y0, 0, 1)
        if image.ndim == 2:
            img = image[..., None]
        else:
            img = image
        out = (
            img[y0, x0] * ((1 - fx) * (1 - fy))[..., None]
            + img[y0, x1] * (fx * (1 - fy))[..., None]
            + img[y1, x0] * ((1 - fx) * fy)[..., None]
            + img[y1, x1] * (fx * fy)[..., None]
        )
        out = out * self.mask[..., None]
        return out[..., 0] if image.ndim == 2 else out


def _rodrigues(v: np.ndarray) -> np.ndarray:
    """axis-angle (3,) -> rotation matrix."""
    th = float(np.linalg.norm(v))
    if th < 1e-12:
        return np.eye(3)
    k = v / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _log_so3(R: np.ndarray) -> np.ndarray:
    """rotation matrix -> axis-angle (3,)."""
    cos = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = float(np.arccos(cos))
    if th < 1e-12:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * th / (2 * np.sin(th))


class StereoRectifyMap:
    """Bouguet stereo rectification for a radial-tangential pair — the
    numpy replacement for the cv::stereoRectify + initUndistortRectifyMap
    plumbing that feeds the reference's stereo SGM path (reference:
    src/gaussian_mapper.cpp:88-97 createStereoSGM + stereo_Q_, and the
    ORB-SLAM3 EuRoC stereo rectification config).

    Inputs: the two (distorted) cameras and the cam0->cam1 transform
    (x1 = R @ x0 + t). Produces a rectified virtual camera (same K for both
    eyes, y-aligned epipolar lines, baseline along +x) plus per-eye remap
    grids. `R1` rotates cam0 coords into the rectified frame, so a
    world-to-cam0 pose (Rw, tw) becomes the rectified pose (R1 @ Rw, R1 @ tw).
    """

    def __init__(self, cam_left: Camera, cam_right: Camera,
                 R: np.ndarray, t: np.ndarray, scale: int = 1):
        om = _log_so3(np.asarray(R, np.float64))
        r_half = _rodrigues(-0.5 * om)  # R^{-1/2}
        tn = r_half @ np.asarray(t, np.float64)
        uu = np.array([1.0 if tn[0] > 0 else -1.0, 0.0, 0.0])
        ww = np.cross(tn, uu)
        nw = np.linalg.norm(ww)
        if nw > 1e-12:
            ww *= np.arccos(np.clip(abs(tn[0]) / np.linalg.norm(tn), -1, 1)) / nw
        wR = _rodrigues(ww)
        self.R1 = wR @ r_half.T  # cam0 -> rectified
        self.R2 = wR @ r_half  # cam1 -> rectified
        self.baseline = float(np.linalg.norm(t))

        f = 0.5 * (cam_left.fy + cam_right.fy) / scale
        w, h = cam_left.width // scale, cam_left.height // scale
        self.camera = Camera(
            camera_id=cam_left.camera_id, width=w, height=h,
            fx=f, fy=f, cx=(w - 1) / 2.0, cy=(h - 1) / 2.0,
        )
        self._left = self._build_map(cam_left, self.R1)
        self._right = self._build_map(cam_right, self.R2)

    def _build_map(self, cam: Camera, Rrect: np.ndarray):
        h, w = self.camera.height, self.camera.width
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        x = (xs - self.camera.cx) / self.camera.fx
        y = (ys - self.camera.cy) / self.camera.fy
        rays = np.stack([x, y, np.ones_like(x)], axis=-1) @ Rrect  # R^T @ ray
        xn = rays[..., 0] / rays[..., 2]
        yn = rays[..., 1] / rays[..., 2]
        k1, k2, p1, p2, k3 = cam.dist_coeffs
        r2 = xn * xn + yn * yn
        radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        xd = xn * radial + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
        yd = yn * radial + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
        map_x = (xd * cam.fx + cam.cx).astype(np.float32)
        map_y = (yd * cam.fy + cam.cy).astype(np.float32)
        mask = (
            (map_x >= 0) & (map_x <= cam.width - 1)
            & (map_y >= 0) & (map_y <= cam.height - 1)
            & (rays[..., 2] > 0)
        ).astype(np.float32)
        return map_x, map_y, mask

    @property
    def mask_left(self) -> np.ndarray:
        return self._left[2]

    def remap_left(self, image: np.ndarray) -> np.ndarray:
        return _bilinear_remap(image, *self._left)

    def remap_right(self, image: np.ndarray) -> np.ndarray:
        return _bilinear_remap(image, *self._right)

    def rectify_pose(self, quat_wxyz: np.ndarray, trans: np.ndarray):
        """world-to-cam0 -> world-to-rectified-left (quat wxyz, trans)."""
        Rw = se3.quat_to_rotmat(torch.as_tensor(
            np.asarray(quat_wxyz, np.float32))).numpy()
        Rn = self.R1 @ Rw
        q = se3.rotmat_to_quat(torch.as_tensor(
            np.asarray(Rn, np.float32))).numpy()
        return q, (self.R1 @ np.asarray(trans, np.float64)).astype(np.float32)
