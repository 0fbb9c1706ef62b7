"""Offline training on a COLMAP scene, the `train_colmap` equivalent.

Port of segs_slam_tpu/apps/train_colmap.py: loads a COLMAP sparse model and
its images, seeds anchors from the sparse points, runs the optimisation on
the card (kernels K1 and K2 in every step) and reports PSNR/SSIM through the
Trainer's EvalRenderer (kernel K3) (reference: examples/train_colmap.cpp:
35-305 + GaussianMapper::trainColmap).

    python -m segs_slam_tpu_torch.apps.train_colmap --scene <dir with
        sparse/0 and images/> [--iters 30000] [--yaml cfg.yaml]
        [--compact 0 --kmax 0] [--out dir] [--device cuda]

`--compact 0 --kmax 0` trains and evaluates through the exact binning (no
compaction cap, no footprint clamp: RasterConfig.exact), as the published
rasterizer bins.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from segs_slam_tpu_torch.core.camera import Camera
from segs_slam_tpu_torch.core.keyframe import Keyframe
from segs_slam_tpu_torch.io.checkpoint import (
    save_cameras_json,
    save_cfg_args,
    save_mlp_checkpoints_txt,
    save_train_state,
)
from segs_slam_tpu_torch.apps.common import raster_config
from segs_slam_tpu_torch.io.colmap import read_scene
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.train.config import OptimizationConfig
from segs_slam_tpu_torch.train.trainer import Trainer


def main(argv=None) -> dict:
    """Train and evaluate. Returns the `evaluate` metrics plus
    `iterations`, `ms_per_iter` (host clock around Trainer.train to a
    synchronised device) and `trainer` (the Trainer, for callers that go on
    with the map)."""
    p = argparse.ArgumentParser()
    p.add_argument("--scene", required=True)
    p.add_argument("--images", default="images")
    p.add_argument("--sparse", default="sparse/0")
    p.add_argument("--iters", type=int, default=30_000)
    p.add_argument("--yaml", default="")
    p.add_argument("--capacity", type=int, default=2**16)
    p.add_argument("--compact", type=int, default=2**16)
    p.add_argument("--kmax", type=int, default=8)
    p.add_argument("--ksmall", type=int, default=4)
    p.add_argument("--nlarge", type=int, default=2**13)
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--out", default="")
    p.add_argument("--log-every", type=int, default=500)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    scene_dir = Path(args.scene)
    scene = read_scene(scene_dir / args.sparse)
    if args.yaml:
        from segs_slam_tpu_torch.io.config_yaml import load_mapper_yaml

        mc, oc, _, extras = load_mapper_yaml(args.yaml, capacity=args.capacity)
    else:
        mc = ModelConfig(capacity=args.capacity)
        oc = OptimizationConfig(iterations=args.iters,
                                use_frequency_regularization=False)

    from PIL import Image

    # one camera (the common COLMAP export): its dims
    cam0 = next(iter(scene.cameras.values()))
    fx, fy, cx, cy = cam0.focal_and_center()
    s = args.downscale
    cam = Camera(camera_id=cam0.camera_id, width=cam0.width // s,
                 height=cam0.height // s, fx=fx / s, fy=fy / s,
                 cx=cx / s, cy=cy / s)
    # packed_train stays off, as in the JAX app: the f32 training binning
    rc = raster_config(args, mc.n_offsets, packed_train="off")
    trainer = Trainer(mc, oc, rc, width=cam.width, height=cam.height,
                      device=args.device)
    trainer.scene.add_camera(cam)

    for img in scene.images.values():
        img_path = scene_dir / args.images / img.name
        if not img_path.exists():
            continue
        pil = Image.open(img_path).convert("RGB")
        if s != 1:
            pil = pil.resize((cam.width, cam.height), Image.BILINEAR)
        arr = np.asarray(pil, np.float32) / 255.0
        kf = Keyframe(kf_id=img.image_id, camera=cam, quat=img.qvec,
                      trans=img.tvec, image=arr)
        trainer.add_keyframe(kf)
    print(f"{len(trainer.scene.keyframes)} keyframes, "
          f"{len(scene.points_xyz)} sparse points")

    n = trainer.initialize_map(scene.points_xyz)
    print(f"initialized {n} anchors")
    t0 = time.perf_counter()
    trainer.train(args.iters, log_every=args.log_every)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    dt = time.perf_counter() - t0
    print(f"trained in {dt:.0f}s")
    metrics = trainer.evaluate()
    print("eval:", {k: round(v, 4) for k, v in metrics.items()})
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        trainer.save_ply(out / "anchors.ply")
        save_train_state(out / "ckpt", trainer.state)
        save_mlp_checkpoints_txt(out / "mlps", trainer.state.decoders)
        save_cameras_json(out / "cameras.json", trainer.scene.keyframes)
        save_cfg_args(out / "cfg_args", mc, trainer.white_background,
                      str(scene_dir))
    return dict(metrics, iterations=trainer.iteration,
                ms_per_iter=1000.0 * dt / max(trainer.iteration, 1),
                trainer=trainer)


if __name__ == "__main__":
    main()
