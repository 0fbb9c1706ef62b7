"""COLMAP binary scene loader (cameras.bin / images.bin / points3D.bin).

Pure-Python reimplementation of the readers used by the offline trainer
(reference: examples/train_colmap.cpp:35-240 readColmapCamerasBinary /
readColmapImagesBinary / readColmapPoints3DBinary, built on
third_party/colmap/utils/endian.h little-endian readers). The binary format
is the public COLMAP sparse-model layout.

Copy of segs_slam_tpu/io/colmap.py (numpy only).
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

# COLMAP camera model id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclasses.dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    def focal_and_center(self) -> tuple[float, float, float, float]:
        if self.model == "SIMPLE_PINHOLE":
            f, cx, cy = self.params[:3]
            return f, f, cx, cy
        if self.model == "PINHOLE":
            fx, fy, cx, cy = self.params[:4]
            return fx, fy, cx, cy
        if self.model in ("SIMPLE_RADIAL", "RADIAL"):
            f, cx, cy = self.params[:3]
            return f, f, cx, cy
        if self.model in ("OPENCV", "FULL_OPENCV", "OPENCV_FISHEYE"):
            fx, fy, cx, cy = self.params[:4]
            return fx, fy, cx, cy
        raise ValueError(f"unsupported COLMAP camera model {self.model}")


@dataclasses.dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # (w, x, y, z) world-to-camera rotation
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray  # (n, 2)
    point3d_ids: np.ndarray  # (n,)


def _read(fmt: str, f) -> tuple:
    size = struct.calcsize(fmt)
    return struct.unpack("<" + fmt, f.read(size))


def read_cameras_binary(path: str | Path) -> dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as f:
        (num,) = _read("Q", f)
        for _ in range(num):
            cam_id, model_id, width, height = _read("iiQQ", f)
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read("d" * n_params, f))
            cameras[cam_id] = ColmapCamera(cam_id, name, width, height, params)
    return cameras


def read_images_binary(path: str | Path) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (num,) = _read("Q", f)
        for _ in range(num):
            image_id = _read("i", f)[0]
            qvec = np.array(_read("dddd", f))
            tvec = np.array(_read("ddd", f))
            camera_id = _read("i", f)[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read("Q", f)
            data = np.frombuffer(f.read(24 * n_pts), dtype=np.float64).reshape(n_pts, 3)
            xys = data[:, :2].copy()
            point3d_ids = data[:, 2].copy().view(np.int64).reshape(-1)
            images[image_id] = ColmapImage(
                image_id, qvec, tvec, camera_id, name.decode("utf-8"),
                xys, point3d_ids,
            )
    return images


def read_points3d_binary(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Returns (xyz (n, 3) f64, rgb (n, 3) u8)."""
    with open(path, "rb") as f:
        (num,) = _read("Q", f)
        xyz = np.zeros((num, 3))
        rgb = np.zeros((num, 3), np.uint8)
        for i in range(num):
            _pid = _read("Q", f)
            xyz[i] = _read("ddd", f)
            rgb[i] = _read("BBB", f)
            _err = _read("d", f)
            (track_len,) = _read("Q", f)
            f.read(8 * track_len)
    return xyz, rgb


@dataclasses.dataclass
class ColmapScene:
    cameras: dict[int, ColmapCamera]
    images: dict[int, ColmapImage]
    points_xyz: np.ndarray
    points_rgb: np.ndarray


def read_scene(sparse_dir: str | Path) -> ColmapScene:
    sparse_dir = Path(sparse_dir)
    xyz, rgb = read_points3d_binary(sparse_dir / "points3D.bin")
    return ColmapScene(
        cameras=read_cameras_binary(sparse_dir / "cameras.bin"),
        images=read_images_binary(sparse_dir / "images.bin"),
        points_xyz=xyz,
        points_rgb=rgb,
    )
