"""Generate a synthetic RGB-D dataset on disk in the Replica (NICE-SLAM) layout.

Port of segs_slam_tpu/utils/make_dataset.py on the port's `rasterize`
(kernel K1 on a card). Renders the synthetic gaussian room (colour +
expected depth) along a trajectory and writes results/frameXXXXXX.jpg,
results/depthXXXXXX.png and traj.txt, so that the online SLAM apps (native
decode -> native tracking -> mapping) run end to end with no external data.
The scene, the trajectory and the camera are the JAX maker's, from the same
numpy seeds.

    python -m segs_slam_tpu_torch.utils.make_dataset --out seq/ \
        [--frames 200] [--size 320] [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from segs_slam_tpu_torch.core.camera import Camera
from segs_slam_tpu_torch.utils.make_rgbd_dataset import render_frames
from segs_slam_tpu_torch.utils.synthetic import make_room_scene, make_trajectory

DEPTH_SCALE = 6553.5


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--size", type=int, default=320)
    p.add_argument("--gaussians", type=int, default=6000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from PIL import Image

    out = Path(args.out)
    (out / "results").mkdir(parents=True, exist_ok=True)
    w = h = args.size
    cam = Camera(camera_id=0, width=w, height=h, fx=0.9 * w, fy=0.9 * w,
                 cx=w / 2, cy=h / 2)
    means, scales, quats, opac, colors = make_room_scene(args.gaussians)
    # near-opaque gaussians give clean depth for the tracker
    opac = np.clip(opac + 0.25, 0, 0.98)
    poses = make_trajectory(args.frames)

    traj_rows = []
    for i, kf, rgb, d in render_frames(
            (means, scales, quats, opac, colors), poses, cam, args.device):
        rgb8 = (rgb * 255).astype(np.uint8)
        Image.fromarray(rgb8).save(out / "results" / f"frame{i:06d}.jpg",
                                   quality=95)
        d16 = np.clip(d * DEPTH_SCALE, 0, 65535).astype(np.uint16)
        Image.fromarray(d16).save(out / "results" / f"depth{i:06d}.png")

        # traj.txt rows are camera-to-world 4x4
        W2C = np.eye(4)
        W2C[:3, :3] = kf.rotation_matrix()
        W2C[:3, 3] = kf.trans
        C2W = np.linalg.inv(W2C)
        traj_rows.append(C2W.reshape(-1))
    np.savetxt(out / "traj.txt", np.array(traj_rows))
    print(f"wrote {args.frames} frames to {out}")


if __name__ == "__main__":
    main()
