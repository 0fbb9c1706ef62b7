"""Offscreen novel-view renderer: an orbit of views of a map, to PNGs.

Port of segs_slam_tpu/apps/render_views.py (the viewer's renderFromPose
equivalent, reference: src/gaussian_mapper.cpp:2484-2538). The JAX app reads
an orbax TrainState, which needs JAX; this one reads a map file written by
segs_slam_tpu_torch.io.convert.save_map (the state's anchors and decoders as
numpy arrays). As the JAX app does, it sizes the eval config on four of the
orbit's views (calibrate_eval_config) and renders through EvalRenderer: the
packed eval binning and kernel K3.

Usage:
  python -m segs_slam_tpu_torch.apps.render_views --map map.npz --out frames/ \
      [--orbit-frames 60] [--size 480] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from segs_slam_tpu_torch.core import se3
from segs_slam_tpu_torch.core.camera import Camera
from segs_slam_tpu_torch.core.keyframe import Keyframe
from segs_slam_tpu_torch.io.convert import load_map
from segs_slam_tpu_torch.io.png import write_png
from segs_slam_tpu_torch.models.renderer import (
    EvalRenderer,
    calibrate_eval_config,
)
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig


def orbit_poses(center, radius, height, n, look_at):
    """n world-to-camera poses (quat (w,x,y,z), translation) on a circle
    around `center`, each looking at `look_at`."""
    poses = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        cam_pos = center + np.array(
            [radius * np.cos(ang), height, radius * np.sin(ang)])
        look = look_at - cam_pos
        look = look / np.linalg.norm(look)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, look)
        right /= np.linalg.norm(right)
        up2 = np.cross(look, right)
        R = np.stack([right, up2, look], axis=0)
        t = -R @ cam_pos
        q = se3.rotmat_to_quat(torch.as_tensor(R, dtype=torch.float32))
        poses.append((q.numpy(), t))
    return poses


def main(argv=None) -> list[dict]:
    """Render the orbit; returns one dict per view: image (3, H, W) float32
    numpy, ms (render time to a synchronised result), pose (quat, trans),
    raster_config (the calibrated eval config), num_compact, num_instances,
    num_kmax_truncated."""
    p = argparse.ArgumentParser()
    p.add_argument("--map", required=True, help="map file (.npz, see "
                   "segs_slam_tpu_torch.io.convert)")
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, default=480)
    p.add_argument("--orbit-frames", type=int, default=60)
    p.add_argument("--orbit-radius", type=float, default=1.5)
    p.add_argument("--compact", type=int, default=2**15)
    p.add_argument("--kmax", type=int, default=8)
    p.add_argument("--ksmall", type=int, default=4)
    p.add_argument("--nlarge", type=int, default=2**13)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    anchors, decoders = load_map(args.map, device)
    mc = dataclasses.replace(decoders.config, capacity=anchors.capacity)

    w = h = args.size
    cam = Camera(camera_id=0, width=w, height=h, fx=0.9 * w, fy=0.9 * w,
                 cx=w / 2, cy=h / 2)
    rc = RasterConfig(tile=16, compact=args.compact, kmax=args.kmax, chunk=256,
                      ksmall=args.ksmall,
                      nlarge=args.nlarge if args.ksmall else 0)

    active = anchors.active.cpu().numpy()
    center = anchors.anchor.cpu().numpy()[active].mean(axis=0)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    poses = orbit_poses(center, args.orbit_radius, -0.3, args.orbit_frames,
                        center + np.array([0, 0, 0.5]))

    def cam_inputs(i, q, t):
        kf = Keyframe(kf_id=i, camera=cam, quat=q, trans=t)
        return {k: torch.as_tensor(v, device=device)
                for k, v in kf.render_inputs().items()}

    cal_cams = [cam_inputs(i, q, t) for i, (q, t) in
                enumerate(poses[::max(1, len(poses) // 4)])]
    rc = calibrate_eval_config(rc, mc, anchors, decoders, cal_cams[:4], w, h)
    renderer = EvalRenderer(mc, rc, w, h, torch.zeros(3), device=device)

    views = []
    for i, (q, t) in enumerate(poses):
        cam_in = cam_inputs(i, q, t)
        t0 = time.perf_counter()
        res = renderer.render_with_counts(anchors, decoders, cam_in)
        img = res["image"].cpu().numpy()  # waits for the device
        ms = (time.perf_counter() - t0) * 1e3
        rgb8 = (np.clip(np.transpose(img, (1, 2, 0)), 0, 1) * 255
                ).astype(np.uint8)
        write_png(out / f"view{i:04d}.png", rgb8)
        views.append({
            "image": img,
            "ms": ms,
            "pose": (q, t),
            "raster_config": rc,
            **{k: int(res[k]) for k in ("num_compact", "num_instances",
                                        "num_kmax_truncated")},
        })
    print(f"wrote {len(poses)} views to {out}")
    return views


if __name__ == "__main__":
    main()
