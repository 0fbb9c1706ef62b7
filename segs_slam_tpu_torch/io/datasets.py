"""Dataset loaders: Replica (NICE-SLAM layout), TUM RGB-D, EuRoC stereo.

Frame-level readers matching the reference's example loaders
(reference: examples/replica_rgbd.cpp LoadImages, examples/tum_rgbd.cpp:91-117
association parsing, examples/euroc_stereo.cpp). Images load via PIL.

Copy of segs_slam_tpu/io/datasets.py with the port's torch `se3` (the
rotations converted in f32, as there).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from segs_slam_tpu_torch.core import se3


def _f32(x) -> torch.Tensor:
    """x as a float32 tensor: the poses' rotations are converted in f32,
    as the JAX loaders convert them."""
    return torch.as_tensor(np.asarray(x, np.float32))


def _imread(path: str | Path, grayscale: bool = False) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    if grayscale:
        img = img.convert("L")
        return np.asarray(img, np.float32) / 255.0
    img = img.convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def _read_depth_png(path: str | Path, scale: float) -> np.ndarray:
    from PIL import Image

    d = np.asarray(Image.open(path))
    return d.astype(np.float32) / scale


@dataclasses.dataclass
class Frame:
    timestamp: float
    quat: np.ndarray  # (4,) w,x,y,z world-to-camera
    trans: np.ndarray  # (3,)
    rgb_path: str
    depth_path: str | None = None

    def load_rgb(self) -> np.ndarray:
        return _imread(self.rgb_path)

    def load_depth(self, scale: float) -> np.ndarray | None:
        if self.depth_path is None:
            return None
        return _read_depth_png(self.depth_path, scale)


def _invert_pose(R: np.ndarray, t: np.ndarray):
    """camera-to-world -> world-to-camera (quat wxyz, trans)."""
    Rw = R.T
    tw = -Rw @ t
    q = se3.rotmat_to_quat(_f32(Rw)).numpy()
    return q, tw


def load_replica(seq_dir: str | Path, depth_scale: float = 6553.5) -> list[Frame]:
    """Replica in NICE-SLAM layout: results/frameXXXXXX.jpg,
    results/depthXXXXXX.png, traj.txt with 4x4 camera-to-world per line
    (reference: examples/replica_rgbd.cpp)."""
    seq_dir = Path(seq_dir)
    traj = np.loadtxt(seq_dir / "traj.txt").reshape(-1, 4, 4)
    frames = []
    for i, T in enumerate(traj):
        rgb = seq_dir / "results" / f"frame{i:06d}.jpg"
        depth = seq_dir / "results" / f"depth{i:06d}.png"
        if not rgb.exists():
            break
        q, t = _invert_pose(T[:3, :3], T[:3, 3])
        frames.append(
            Frame(
                timestamp=float(i),
                quat=q,
                trans=t,
                rgb_path=str(rgb),
                depth_path=str(depth) if depth.exists() else None,
            )
        )
    return frames


def load_tum_rgbd(seq_dir: str | Path, depth_scale: float = 5000.0) -> list[Frame]:
    """TUM RGB-D with associations: associates rgb.txt/depth.txt/
    groundtruth.txt by nearest timestamp (reference: examples/tum_rgbd.cpp +
    the standard associate.py logic)."""
    seq_dir = Path(seq_dir)

    def read_list(name):
        entries = []
        with open(seq_dir / name) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                entries.append((float(parts[0]), parts[1:]))
        return entries

    rgb = read_list("rgb.txt")
    depth = read_list("depth.txt")
    gt = read_list("groundtruth.txt")
    gt_times = np.array([t for t, _ in gt])
    d_times = np.array([t for t, _ in depth])

    frames = []
    for t_rgb, (rgb_rel,) in rgb:
        di = int(np.argmin(np.abs(d_times - t_rgb)))
        gi = int(np.argmin(np.abs(gt_times - t_rgb)))
        if abs(d_times[di] - t_rgb) > 0.02 or abs(gt_times[gi] - t_rgb) > 0.02:
            continue
        tx, ty, tz, qx, qy, qz, qw = map(float, gt[gi][1][:7])
        # gt is camera-to-world; convert
        Rcw = se3.quat_to_rotmat(_f32([qw, qx, qy, qz])).numpy()
        q, t = _invert_pose(Rcw, np.array([tx, ty, tz]))
        frames.append(
            Frame(
                timestamp=t_rgb,
                quat=q,
                trans=t,
                rgb_path=str(seq_dir / rgb_rel),
                depth_path=str(seq_dir / depth[di][1][0]),
            )
        )
    return frames


def load_scannet(seq_dir: str | Path, depth_scale: float = 1000.0) -> list[Frame]:
    """ScanNet sens-export layout: color/<i>.jpg, depth/<i>.png (uint16 mm),
    pose/<i>.txt (4x4 camera-to-world) (reference: examples/scannet_rgbd.cpp
    :89-103 reads color/ + depth/ pairs; poses come from the exported pose/
    directory, which the reference's evaluation consumes as ground truth).
    Frames with invalid exported poses (inf rows) are skipped, matching the
    standard ScanNet convention."""
    seq_dir = Path(seq_dir)
    color_dir = seq_dir / "color"

    def frame_key(p: Path):
        try:
            return (0, int(p.stem))
        except ValueError:
            return (1, p.stem)

    frames = []
    for rgb in sorted(color_dir.glob("*.jpg"), key=frame_key):
        depth = seq_dir / "depth" / f"{rgb.stem}.png"
        pose = seq_dir / "pose" / f"{rgb.stem}.txt"
        if not pose.exists():
            continue
        T = np.loadtxt(pose).reshape(4, 4)
        if not np.isfinite(T).all():
            continue
        q, t = _invert_pose(T[:3, :3], T[:3, 3])
        frames.append(
            Frame(
                timestamp=float(int(rgb.stem)) if rgb.stem.isdigit() else 0.0,
                quat=q,
                trans=t,
                rgb_path=str(rgb),
                depth_path=str(depth) if depth.exists() else None,
            )
        )
    return frames


def load_scannet_intrinsics(seq_dir: str | Path) -> dict | None:
    """Read intrinsic/intrinsic_color.txt (4x4 K matrix) if present."""
    p = Path(seq_dir) / "intrinsic" / "intrinsic_color.txt"
    if not p.exists():
        return None
    K = np.loadtxt(p).reshape(4, 4)
    return dict(fx=float(K[0, 0]), fy=float(K[1, 1]),
                cx=float(K[0, 2]), cy=float(K[1, 2]))


def load_euroc_stereo(seq_dir: str | Path) -> list[tuple["Frame", str]]:
    """EuRoC MAV stereo: mav0/cam0 + mav0/cam1 image streams and the
    ground-truth state estimate, associated by timestamp (reference:
    examples/euroc_stereo.cpp LoadImages). Returns (left Frame, right path)
    pairs; poses are body-frame ground truth converted to world-to-camera
    using the standard EuRoC cam0 extrinsics.
    """
    seq_dir = Path(seq_dir)
    mav = seq_dir / "mav0"

    def read_csv(path):
        rows = []
        with open(path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                rows.append(line.strip().split(","))
        return rows

    cam0 = read_csv(mav / "cam0" / "data.csv")
    cam1 = {r[0]: r[1] for r in read_csv(mav / "cam1" / "data.csv")}
    gt_rows = read_csv(mav / "state_groundtruth_estimate0" / "data.csv")
    gt_t = np.array([float(r[0]) for r in gt_rows]) * 1e-9
    gt_pos = np.array([[float(r[1]), float(r[2]), float(r[3])] for r in gt_rows])
    gt_quat = np.array(
        [[float(r[4]), float(r[5]), float(r[6]), float(r[7])] for r in gt_rows]
    )  # w x y z, body-to-world

    # standard EuRoC cam0-to-body extrinsics (sensor.yaml T_BS)
    T_BS = np.array([
        [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
        [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
        [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
        [0.0, 0.0, 0.0, 1.0],
    ])

    frames = []
    for ts_ns, rel in cam0:
        t_s = float(ts_ns) * 1e-9
        gi = int(np.argmin(np.abs(gt_t - t_s)))
        if abs(gt_t[gi] - t_s) > 0.05:
            continue
        qw, qx, qy, qz = gt_quat[gi]
        R_wb = se3.quat_to_rotmat(_f32([qw, qx, qy, qz])).numpy()
        T_WB = np.eye(4)
        T_WB[:3, :3] = R_wb
        T_WB[:3, 3] = gt_pos[gi]
        T_WC = T_WB @ T_BS  # camera-to-world
        q, t = _invert_pose(T_WC[:3, :3], T_WC[:3, 3])
        right_rel = cam1.get(ts_ns)
        frames.append((
            Frame(
                timestamp=t_s, quat=q, trans=t,
                rgb_path=str(mav / "cam0" / "data" / rel),
            ),
            str(mav / "cam1" / "data" / right_rel) if right_rel else None,
        ))
    return frames
