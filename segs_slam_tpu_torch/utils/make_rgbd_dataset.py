"""Generate a synthetic RGB-D dataset on disk in the Replica NICE-SLAM layout.

Port of segs_slam_tpu/utils/make_rgbd_dataset.py on the port's
`rasterize` (kernel K1 on a card). Renders the synthetic gaussian room along
a trajectory and writes

  <out>/results/frame%06d.jpg          (RGB)
  <out>/results/depth%06d.png          (uint16, depth * depth_scale)
  <out>/traj.txt                       (4x4 camera-to-world per line, row-major)

so that `apps/slam_rgbd.py --dataset replica` runs end to end with no
external data (reference entry point: examples/replica_rgbd.cpp, NICE-SLAM
dataset layout). The scene, the trajectory and the camera are the JAX
maker's, from the same numpy seeds; `render_frames` returns a frame's
arrays before they are encoded.

With --loop the trajectory is a closed orbit that revisits its starting pose
(a ground-truth loop-closure scenario). With --imu an inertial stream
derived from the trajectory is written to <out>/imu.txt (utils/make_imu.py).

    python -m segs_slam_tpu_torch.utils.make_rgbd_dataset --out seq/ \
        [--frames 200] [--width 640] [--height 480] [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from segs_slam_tpu_torch.core import se3
from segs_slam_tpu_torch.core.camera import Camera
from segs_slam_tpu_torch.core.keyframe import Keyframe
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig, rasterize
from segs_slam_tpu_torch.utils.make_imu import derive_imu, write_imu_txt
from segs_slam_tpu_torch.utils.synthetic import make_room_scene, make_trajectory

DEPTH_SCALE = 6553.5  # Replica convention: uint16 = meters * 6553.5


def make_loop_trajectory(n_views: int, seed: int = 0):
    """Closed orbit: yaw sweeps a full 2*pi so the final views re-observe the
    first views' scene content (loop-closure ground truth)."""
    rng = np.random.default_rng(seed)
    room_center = np.array([0.0, 0.0, 3.0])  # interior of make_room_scene box
    poses = []
    for i in range(n_views):
        ang = 2.0 * np.pi * i / n_views
        radius = 0.9 + 0.05 * np.sin(3 * ang)
        center = room_center + np.array(
            [radius * np.sin(ang), 0.15 * np.sin(2 * ang),
             radius * np.cos(ang)])
        center += rng.normal(scale=0.01, size=3)
        # look outward from the room center, tangentially biased
        fwd = np.array([np.sin(ang + 0.35), -0.08, np.cos(ang + 0.35)])
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        true_up = np.cross(fwd, right)
        R = np.stack([right, true_up, fwd], axis=0)  # world-to-camera
        q = se3.rotmat_to_quat(torch.as_tensor(R, dtype=torch.float32))
        poses.append((q.numpy(), -R @ center))
    return poses


def scene_and_poses(n_frames: int, n_gaussians: int, seed: int, loop: bool):
    """The JAX maker's scene ((means, scales, quats, opacities, colours),
    float32 numpy) and trajectory ((quat, trans) world-to-camera pairs)."""
    means, scales, quats, opac, colors = make_room_scene(n_gaussians,
                                                         seed=seed)
    if loop:
        # close the box: make_room_scene leaves the z=0 face open (the room
        # "entrance"); an inward-looking orbit sweeps past it. A front wall
        # gives every orbit segment structure.
        rng = np.random.default_rng(seed + 1)
        n_front = n_gaussians // 5
        u = rng.uniform(0, 1, n_front)
        v = rng.uniform(0, 1, n_front)
        front = np.stack([-2 + 4 * u, -1.5 + 3 * v, np.zeros(n_front)],
                         axis=1).astype(np.float32)
        fcol = np.stack([0.3 + 0.6 * u, 0.2 + 0.3 * v, 0.7 - 0.5 * u],
                        axis=1).astype(np.float32)
        fscale = np.exp(rng.uniform(-4.3, -3.0, (n_front, 3))).astype(
            np.float32)
        fquat = rng.normal(size=(n_front, 4)).astype(np.float32)
        fquat /= np.linalg.norm(fquat, axis=1, keepdims=True)
        means = np.concatenate([means, front])
        colors = np.concatenate([colors, fcol])
        scales = np.concatenate([scales, fscale])
        quats = np.concatenate([quats, fquat])
        opac = np.concatenate([opac, np.full(n_front, 0.995, np.float32)])
    # near-opaque surfaces: with semi-transparent gaussians the alpha-blended
    # depth mixes fore/background view-dependently, which poisons RGB-D
    # tracking and densification; with alpha ~1 the first hit dominates
    opac = np.full_like(opac, 0.995)
    poses = (make_loop_trajectory(n_frames, seed=seed) if loop
             else make_trajectory(n_frames))
    return (means, scales, quats, opac, colors), poses


def render_frames(scene, poses, cam: Camera, device="cuda",
                  photometric: bool = False):
    """Yield (index, keyframe, rgb (H, W, 3) in [0, 1], depth (H, W) in
    meters with 0 where the alpha is 0.5 or less) per pose: the arrays the
    maker encodes, before encoding."""
    dev = torch.device(device)
    cfg = RasterConfig(tile=16, compact=2**14, kmax=16, chunk=128)
    args = [torch.as_tensor(np.asarray(x, np.float32), device=dev)
            for x in scene]
    bg = torch.zeros(3, device=dev)
    for i, (q, t) in enumerate(poses):
        kf = Keyframe(kf_id=i, camera=cam, quat=q, trans=t)
        with torch.inference_mode():
            o = rasterize(
                *args, torch.as_tensor(kf.world_view_transform, device=dev),
                torch.as_tensor(kf.full_proj_transform, device=dev),
                cam.width, cam.height, cam.tan_fovx, cam.tan_fovy, bg,
                config=cfg)
        img, depth, final_t = (o[k].cpu().numpy()
                               for k in ("image", "depth_map", "final_T"))
        rgb = np.clip(img.transpose(1, 2, 0), 0, 1)
        if photometric:
            # smooth exposure + white-balance drive along the trajectory
            # (auto-exposure/AWB analogue; learnable from pose7)
            exposure = 1.0 + 0.18 * np.sin(2 * np.pi * i / 70.0)
            wb = np.array([
                1.0 + 0.06 * np.sin(2 * np.pi * i / 45.0 + 0.7),
                1.0,
                1.0 - 0.06 * np.sin(2 * np.pi * i / 45.0 + 0.2),
            ])
            rgb = np.clip(rgb * exposure * wb[None, None, :], 0, 1)
        alpha = 1.0 - final_t
        d = np.where(alpha > 0.5, depth / np.maximum(alpha, 1e-6), 0.0)
        yield i, kf, rgb, d


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--gaussians", type=int, default=8000)
    p.add_argument("--loop", action="store_true",
                   help="closed-orbit trajectory for loop-closure testing")
    p.add_argument("--imu", action="store_true",
                   help="derive a 200 Hz IMU stream (imu.txt) from the "
                        "trajectory (reference analogue: the inertial entry "
                        "points; see utils/make_imu.py)")
    p.add_argument("--imu-rate", type=float, default=200.0)
    p.add_argument("--imu-gyro-bias", type=float, nargs=3, default=[0, 0, 0],
                   help="constant gyro bias [rad/s] baked into the stream "
                        "(exercises the tracker's online bias estimator)")
    p.add_argument("--imu-gravity", type=float, nargs=3,
                   default=[0.0, 9.81, 0.0],
                   help="world gravity vector the accelerometer measures "
                        "against (non-default exercises the tracker's "
                        "online gravity initializer)")
    p.add_argument("--photometric", action="store_true",
                   help="per-frame exposure / white-balance variation "
                        "(reference: src/gaussian_renderer.cpp:256-270)")
    p.add_argument("--cam-fps", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from PIL import Image

    out = Path(args.out)
    res = out / "results"
    res.mkdir(parents=True, exist_ok=True)
    w, h = args.width, args.height
    cam = Camera(camera_id=0, width=w, height=h, fx=0.9 * w, fy=0.9 * w,
                 cx=w / 2, cy=h / 2)
    scene, poses = scene_and_poses(args.frames, args.gaussians, args.seed,
                                   args.loop)
    traj_rows = []
    for i, kf, rgb, d in render_frames(scene, poses, cam, args.device,
                                       args.photometric):
        Image.fromarray((rgb * 255).astype(np.uint8)).save(
            res / f"frame{i:06d}.jpg", quality=95)
        d16 = np.clip(d * DEPTH_SCALE, 0, 65535).astype(np.uint16)
        Image.fromarray(d16).save(res / f"depth{i:06d}.png")
        # traj.txt rows are camera-to-world 4x4, row-major flattened
        W2C = np.eye(4)
        W2C[:3, :3] = kf.rotation_matrix()
        W2C[:3, 3] = kf.trans
        C2W = np.linalg.inv(W2C)
        traj_rows.append(" ".join(f"{v:.9f}" for v in C2W.reshape(-1)))
    (out / "traj.txt").write_text("\n".join(traj_rows) + "\n")
    print(f"wrote {args.frames} RGB-D frames to {out}")

    if args.imu:
        times, gyro, accel = derive_imu(
            poses, cam_fps=args.cam_fps, imu_rate=args.imu_rate,
            gyro_noise=2e-4, accel_noise=2e-3, seed=args.seed,
            gyro_bias=tuple(args.imu_gyro_bias),
            gravity_w=np.asarray(args.imu_gravity, float))
        write_imu_txt(out / "imu.txt", times, gyro, accel)
        print(f"wrote {len(times)} IMU samples to {out / 'imu.txt'}")


if __name__ == "__main__":
    main()
