"""Generate a synthetic stereo dataset on disk in the EuRoC MAV layout.

Port of segs_slam_tpu/utils/make_stereo_dataset.py on the port's
`rasterize` (kernel K1 on a card). Renders the synthetic gaussian room from
a rectified stereo pair (left camera on the trajectory, right camera offset
by `baseline` along the camera +x axis) and writes

  <out>/mav0/cam0/data/<ts>.png + data.csv     (left, greyscale)
  <out>/mav0/cam1/data/<ts>.png + data.csv     (right)
  <out>/mav0/state_groundtruth_estimate0/data.csv
  <out>/mav0/depth0/<ts>.npy                   (left ground-truth depth)
  <out>/calib.json                             (pinhole intrinsics+baseline)

so that apps/slam_stereo.py --pre-rectified runs end to end with no
external data (reference entry point: examples/euroc_stereo.cpp). Poses
written to the ground-truth csv are pre-multiplied by inv(T_BS) of the
standard EuRoC cam0 extrinsics, so that io/datasets.load_euroc_stereo (which
applies T_BS) recovers the true camera-to-world transforms. The scene, the
trajectory and the camera are the JAX maker's, from the same numpy seeds.

    python -m segs_slam_tpu_torch.utils.make_stereo_dataset --out seq/ \
        [--frames 120] [--width 640] [--height 480] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from segs_slam_tpu_torch.core import se3
from segs_slam_tpu_torch.core.camera import Camera
from segs_slam_tpu_torch.core.keyframe import Keyframe
from segs_slam_tpu_torch.utils.make_rgbd_dataset import render_frames
from segs_slam_tpu_torch.utils.synthetic import make_room_scene, make_trajectory

# must match io/datasets.load_euroc_stereo's cam0 T_BS
EUROC_T_BS = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0],
])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--baseline", type=float, default=0.11)
    p.add_argument("--gaussians", type=int, default=8000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from PIL import Image

    out = Path(args.out)
    cam0 = out / "mav0" / "cam0" / "data"
    cam1 = out / "mav0" / "cam1" / "data"
    gt_dir = out / "mav0" / "state_groundtruth_estimate0"
    depth_dir = out / "mav0" / "depth0"
    for d in (cam0, cam1, gt_dir, depth_dir):
        d.mkdir(parents=True, exist_ok=True)

    w, h, b = args.width, args.height, args.baseline
    cam = Camera(camera_id=0, width=w, height=h, fx=0.9 * w, fy=0.9 * w,
                 cx=w / 2, cy=h / 2)
    means, scales, quats, opac, colors = make_room_scene(args.gaussians)
    # near-opaque surfaces, as in make_rgbd_dataset: semi-transparent
    # gaussians make the photometry view-dependent (splat parallax) and the
    # blended depth a non-surface
    opac = np.full_like(opac, 0.995)
    poses = make_trajectory(args.frames)
    # the pairs' poses in render order: left eye, then the right eye at
    # x_r = x_l - (b, 0, 0) in rectified camera coordinates
    eyes = []
    for q, t in poses:
        eyes += [(q, t), (q, np.asarray(t, np.float64)
                          + np.array([-b, 0.0, 0.0]))]
    views = render_frames((means, scales, quats, opac, colors), eyes, cam,
                          args.device)

    inv_tbs = np.linalg.inv(EUROC_T_BS)
    rows_cam, rows_gt = [], []
    for i, (q, t) in enumerate(poses):
        ts_ns = int((i / 20.0) * 1e9)  # 20 Hz
        for ddir in (cam0, cam1):
            _, _, rgb, d = next(views)
            gray = np.clip(rgb.mean(axis=2), 0, 1)
            Image.fromarray((gray * 255).astype(np.uint8)).save(
                ddir / f"{ts_ns}.png")
            if ddir is cam0:
                np.save(depth_dir / f"{ts_ns}.npy", d.astype(np.float32))

        rows_cam.append(f"{ts_ns},{ts_ns}.png")
        # ground-truth row: T_WB such that the loader's T_WB @ T_BS is the
        # true camera-to-world of cam0
        kf_l = Keyframe(kf_id=i, camera=cam, quat=q, trans=t)
        W2C = np.eye(4)
        W2C[:3, :3] = kf_l.rotation_matrix()
        W2C[:3, 3] = kf_l.trans
        T_WB = np.linalg.inv(W2C) @ inv_tbs
        qb = se3.rotmat_to_quat(torch.as_tensor(T_WB[:3, :3],
                                                dtype=torch.float32)).numpy()
        pb = T_WB[:3, 3]
        rows_gt.append(
            f"{ts_ns},{pb[0]},{pb[1]},{pb[2]},{qb[0]},{qb[1]},{qb[2]},{qb[3]}"
        )

    hdr = "#timestamp [ns],filename\n"
    (out / "mav0" / "cam0" / "data.csv").write_text(hdr + "\n".join(rows_cam))
    (out / "mav0" / "cam1" / "data.csv").write_text(hdr + "\n".join(rows_cam))
    (gt_dir / "data.csv").write_text(
        "#timestamp,px,py,pz,qw,qx,qy,qz\n" + "\n".join(rows_gt)
    )
    (out / "calib.json").write_text(json.dumps({
        "width": w, "height": h, "fx": cam.fx, "fy": cam.fy,
        "cx": cam.cx, "cy": cam.cy, "baseline": b,
    }))
    print(f"wrote {args.frames} stereo pairs to {out}")


if __name__ == "__main__":
    main()
