"""Keyframe: pose + camera + the derived transform tensors the renderer needs.

The four derived tensors mirror the reference exactly so that rendering math
and the `check_colmap.md` golden fixtures carry over
(reference: src/gaussian_keyframe.cpp:151-184 computeTransformTensors):

  world_view_transform = W2C^T                      (4,4)
  projection_matrix    = P^T                         (4,4)
  full_proj_transform  = W2C^T @ P^T                 (4,4)
  camera_center        = inv(W2C^T)[3, :3]           (3,)

plus the sliding-window bookkeeping (times-of-use, pyramid levels) used by the
mapper's keyframe sampler (reference: src/gaussian_mapper.cpp:1459-1495).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from segs_slam_tpu_torch.core.camera import Camera, projection_matrix, world_to_view


@dataclasses.dataclass
class Keyframe:
    kf_id: int
    camera: Camera
    # World-to-camera pose: quaternion (w,x,y,z) + translation. Matches the
    # 7-D pose vector fed to the appearance MLP in the order (t, q)
    # (reference: src/gaussian_renderer.cpp:256-264).
    quat: np.ndarray  # (4,) w,x,y,z
    trans: np.ndarray  # (3,)
    image: np.ndarray | None = None  # (H, W, 3) float32 in [0, 1]
    depth: np.ndarray | None = None  # (H, W) float32, optional (RGB-D)
    timestamp: float = 0.0

    # Mapper bookkeeping (reference: include/gaussian_keyframe.h:100-116)
    remaining_times_of_use: int = 0
    is_loop_keyframe: bool = False
    # Gaussian-pyramid per-sub-level use budgets (reference:
    # getCurrentGausPyramidLevel, src/gaussian_keyframe.cpp:281-290)
    gaus_pyramid_times_of_use: list = None

    # Derived (filled by compute_transform_tensors)
    world_view_transform: np.ndarray | None = None
    projection: np.ndarray | None = None
    full_proj_transform: np.ndarray | None = None
    camera_center: np.ndarray | None = None

    def __post_init__(self):
        self.quat = np.asarray(self.quat, dtype=np.float64)
        self.trans = np.asarray(self.trans, dtype=np.float64)
        self.compute_transform_tensors()

    def set_pose(self, quat: np.ndarray, trans: np.ndarray) -> None:
        self.quat = np.asarray(quat, dtype=np.float64)
        self.trans = np.asarray(trans, dtype=np.float64)
        self.compute_transform_tensors()

    def rotation_matrix(self) -> np.ndarray:
        w, x, y, z = self.quat
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )

    def compute_transform_tensors(self) -> None:
        W2C = world_to_view(self.rotation_matrix(), self.trans)
        self.world_view_transform = W2C.T.astype(np.float32)
        self.projection = projection_matrix(
            self.camera.znear, self.camera.zfar, self.camera.fovx, self.camera.fovy
        ).T.astype(np.float32)
        self.full_proj_transform = (
            self.world_view_transform @ self.projection
        ).astype(np.float32)
        self.camera_center = np.linalg.inv(self.world_view_transform)[3, :3].astype(
            np.float32
        )

    def next_pyramid_level(self, num_sub_levels: int) -> int:
        """Consume one sub-level budget if any remains; otherwise full
        resolution (index == num_sub_levels). reference:
        src/gaussian_keyframe.cpp:281-290."""
        if not self.gaus_pyramid_times_of_use:
            return num_sub_levels
        for i, n in enumerate(self.gaus_pyramid_times_of_use):
            if n > 0:
                self.gaus_pyramid_times_of_use[i] -= 1
                return i
        return num_sub_levels

    def pose7(self) -> np.ndarray:
        """7-D (tx,ty,tz,qw,qx,qy,qz) appearance-MLP input
        (reference: src/gaussian_renderer.cpp:256-264)."""
        return np.concatenate([self.trans, self.quat]).astype(np.float32)

    def render_inputs(self) -> dict:
        """The arrays render() consumes (numpy; the caller moves them to its
        device)."""
        return {
            "world_view_transform": self.world_view_transform,
            "full_proj_transform": self.full_proj_transform,
            "camera_center": self.camera_center,
            "pose7": self.pose7(),
            "tan_fovx": np.float32(self.camera.tan_fovx),
            "tan_fovy": np.float32(self.camera.tan_fovy),
            # needed by in-step pose optimization (apply_pose_delta rebuilds
            # full_proj_transform = wvt @ projection after the SE3 update)
            "projection_matrix": self.projection,
        }
