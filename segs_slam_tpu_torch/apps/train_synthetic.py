"""Offline training on a synthetic multi-view room, end to end with no
dataset: the port of segs_slam_tpu/apps/train_synthetic.py.

Builds a scene, renders its ground-truth views, seeds anchors from a noisy
subsample of the true geometry, runs the optimisation with densification,
and reports PSNR/SSIM over the training views, rendered by the Trainer's
EvalRenderer (the packed eval binning and kernel K3).

Usage:
  python -m segs_slam_tpu_torch.apps.train_synthetic [--iters 3000]
      [--freq-reg] [--device cuda]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from segs_slam_tpu_torch.core.camera import Camera
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from segs_slam_tpu_torch.train.config import OptimizationConfig
from segs_slam_tpu_torch.train.trainer import Trainer
from segs_slam_tpu_torch.utils.synthetic import (
    make_room_scene,
    make_trajectory,
    render_gt_views,
)


def build_trainer(argv=None) -> tuple[Trainer, argparse.Namespace]:
    """The app's Trainer with its keyframes added and its map seeded, from
    the command-line flags; nothing trained yet."""
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=3000)
    p.add_argument("--views", type=int, default=24)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--gaussians", type=int, default=4000)
    p.add_argument("--capacity", type=int, default=2**14)
    p.add_argument("--compact", type=int, default=2**15)
    p.add_argument("--kmax", type=int, default=8)
    p.add_argument("--ksmall", type=int, default=4)
    p.add_argument("--nlarge", type=int, default=2**13)
    p.add_argument("--n-offsets", type=int, default=10)
    p.add_argument("--seed-points", type=int, default=1500)
    p.add_argument("--voxel-size", type=float, default=0.02)
    p.add_argument("--log-every", type=int, default=250)
    p.add_argument("--save-ply", type=str, default="")
    p.add_argument("--freq-reg", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    w = h = args.size
    cam = Camera(camera_id=0, width=w, height=h, fx=0.9 * w, fy=0.9 * w,
                 cx=w / 2, cy=h / 2)

    print("rendering ground-truth views...", flush=True)
    means, scales, quats, opac, colors = make_room_scene(args.gaussians)
    poses = make_trajectory(args.views)
    kfs, _ = render_gt_views(means, scales, quats, opac, colors, poses, cam,
                             device=args.device)

    mc = ModelConfig(capacity=args.capacity, n_offsets=args.n_offsets,
                     voxel_size=args.voxel_size)
    oc = OptimizationConfig(
        iterations=args.iters,
        update_until=min(25_500, int(args.iters * 0.85)),
        frequency_regulization_until=min(25_500, int(args.iters * 0.85)),
        high_frequency_regularization_start=min(5_000, args.iters // 6),
        use_frequency_regularization=args.freq_reg,
    )
    rc = RasterConfig(tile=16, compact=args.compact, kmax=args.kmax,
                      chunk=256, ksmall=args.ksmall,
                      nlarge=args.nlarge if args.ksmall else 0)

    trainer = Trainer(mc, oc, rc, width=w, height=h, device=args.device)
    trainer.scene.add_camera(cam)
    for kf in kfs:
        trainer.add_keyframe(kf)

    # Seed the map from a noisy subsample of the true geometry (the role the
    # SLAM/COLMAP sparse points play).
    rng = np.random.default_rng(1)
    sel = rng.choice(len(means), size=min(args.seed_points, len(means)),
                     replace=False)
    seed_pts = means[sel] + rng.normal(0, 0.01, (len(sel), 3))
    n = trainer.initialize_map(seed_pts)
    print(f"initialized {n} anchors; {args.iters} iters on {len(kfs)} views "
          f"at {w}x{h} on {trainer.device}", flush=True)
    return trainer, args


def main(argv=None) -> dict:
    """Train and evaluate. Returns the `evaluate` metrics after training,
    plus psnr_init (the untrained map's PSNR), losses (every step's loss)
    and ms_per_iter (host clock to a synchronised device)."""
    torch.backends.cuda.matmul.allow_tf32 = False  # SSIM needs full f32
    trainer, args = build_trainer(argv)
    psnr_init = trainer.evaluate()["psnr"]
    print(f"eval before training: psnr {psnr_init:.3f}", flush=True)
    # the JAX app evaluates only after training, so its eval tiers are
    # calibrated on the trained map: calibrate again after training here too
    trainer.reset_eval_renderer()

    history = []
    t0 = time.time()
    trainer.train(args.iters, log_every=args.log_every, history=history)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    dt = time.time() - t0
    ms_per_iter = dt / max(trainer.iteration, 1) * 1000
    print(f"trained in {dt:.1f}s ({ms_per_iter:.1f} ms/iter)")

    metrics = trainer.evaluate()
    print("eval:", {k: round(v, 3) for k, v in metrics.items()})
    metrics.update(psnr_init=psnr_init, ms_per_iter=ms_per_iter,
                   losses=torch.stack(history).cpu().tolist()
                   if history else [])
    if args.save_ply:
        trainer.save_ply(args.save_ply)
        print("saved", args.save_ply)
    return metrics


if __name__ == "__main__":
    main()
