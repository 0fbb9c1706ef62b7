"""Generate a synthetic COLMAP scene on disk (binary sparse model + images).

Port of segs_slam_tpu/utils/make_colmap_dataset.py on the port's
`rasterize` (kernel K1 on a card). Renders the synthetic gaussian room along
a trajectory and writes the layout examples/train_colmap.cpp consumes
(reference: examples/train_colmap.cpp:35-240 readColmapScene; binary formats
per third_party/colmap/utils/endian.h):

  <out>/sparse/0/cameras.bin     (one PINHOLE camera)
  <out>/sparse/0/images.bin      (world-to-camera quat+trans per view)
  <out>/sparse/0/points3D.bin    (subsampled surface points as the sparse
                                  SfM cloud, with per-point colour)
  <out>/images/<name>.png

so that apps/train_colmap.py runs with no external data. The scene, the
trajectory, the camera and the sparse cloud are the JAX maker's, from the
same numpy seeds.

    python -m segs_slam_tpu_torch.utils.make_colmap_dataset --out scene/ \
        [--views 48] [--width 640] [--height 480] [--device cuda]
"""

from __future__ import annotations

import argparse
import struct
from pathlib import Path

import numpy as np

from segs_slam_tpu_torch.core.camera import Camera
from segs_slam_tpu_torch.utils.make_rgbd_dataset import render_frames
from segs_slam_tpu_torch.utils.synthetic import make_room_scene, make_trajectory


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--views", type=int, default=48)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--gaussians", type=int, default=8000)
    p.add_argument("--sparse-points", type=int, default=12000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from PIL import Image

    out = Path(args.out)
    sparse = out / "sparse" / "0"
    imgdir = out / "images"
    sparse.mkdir(parents=True, exist_ok=True)
    imgdir.mkdir(parents=True, exist_ok=True)

    w, h = args.width, args.height
    cam = Camera(camera_id=0, width=w, height=h, fx=0.9 * w, fy=0.9 * w,
                 cx=w / 2, cy=h / 2)
    means, scales, quats, opac, colors = make_room_scene(
        args.gaussians, seed=args.seed)
    opac = np.full_like(opac, 0.995)  # opaque surfaces (see make_rgbd_dataset)
    poses = make_trajectory(args.views)

    # cameras.bin: one PINHOLE camera (model id 1: fx fy cx cy)
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, w, h))
        f.write(struct.pack("<dddd", cam.fx, cam.fy, cam.cx, cam.cy))

    # images.bin: quat (w x y z) + trans, world-to-camera, zero 2D features
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(poses)))
        for i, _, rgb, _ in render_frames(
                (means, scales, quats, opac, colors), poses, cam,
                args.device):
            q, t = poses[i]
            name = f"view{i:04d}.png"
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<dddd", *[float(v) for v in q]))
            f.write(struct.pack("<ddd", *[float(v) for v in t]))
            f.write(struct.pack("<i", 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
            Image.fromarray((rgb * 255).astype(np.uint8)).save(imgdir / name)

    # points3D.bin: subsample of the true surface (the SfM sparse cloud)
    rng = np.random.default_rng(args.seed)
    sel = rng.choice(len(means), min(args.sparse_points, len(means)),
                     replace=False)
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(sel)))
        for pid, si in enumerate(sel):
            xyz = means[si] + rng.normal(scale=0.005, size=3)  # SfM noise
            rgb = (np.clip(colors[si], 0, 1) * 255).astype(np.uint8)
            f.write(struct.pack("<Q", pid + 1))
            f.write(struct.pack("<ddd", *[float(v) for v in xyz]))
            f.write(struct.pack("<BBB", *[int(v) for v in rgb]))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", 0))

    print(f"wrote COLMAP scene: {len(poses)} views, {len(sel)} points -> {out}")


if __name__ == "__main__":
    main()
