"""Synthetic multi-view scenes for self-contained quality gates.

Port of segs_slam_tpu/utils/synthetic.py: render ground-truth views of a
KNOWN scene of explicit gaussians with the port's own rasterizer (kernel K1
on a card), then train the anchor model to reproduce them and measure
PSNR/SSIM. The scene and the trajectory are the JAX module's, from the same
numpy seeds.
"""

from __future__ import annotations

import numpy as np
import torch

from segs_slam_tpu_torch.core import se3
from segs_slam_tpu_torch.core.camera import Camera
from segs_slam_tpu_torch.core.keyframe import Keyframe
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig, rasterize


def make_room_scene(n_gaussians: int = 4000, seed: int = 0):
    """A coloured 'room': gaussians on the walls/floor of a box + clutter.
    Returns float32 numpy (means, scales, quats, opacities, colours)."""
    rng = np.random.default_rng(seed)
    n_wall = n_gaussians * 3 // 4
    n_free = n_gaussians - n_wall

    # box [-2, 2] x [-1.5, 1.5] x [0, 6]
    pts = []
    cols = []
    for _ in range(n_wall):
        face = rng.integers(0, 5)
        u, v = rng.uniform(0, 1, 2)
        if face == 0:  # back wall
            p = [-2 + 4 * u, -1.5 + 3 * v, 6.0]
            c = [0.8 * u, 0.3, 0.8 * v]
        elif face == 1:  # floor
            p = [-2 + 4 * u, 1.5, 6.0 * v]
            c = [0.2, 0.7 * u, 0.4 * v]
        elif face == 2:  # ceiling
            p = [-2 + 4 * u, -1.5, 6.0 * v]
            c = [0.9, 0.8, 0.6 * u]
        elif face == 3:  # left wall
            p = [-2, -1.5 + 3 * u, 6.0 * v]
            c = [0.5 + 0.5 * v, 0.2 + 0.5 * u, 0.1]
        else:  # right wall
            p = [2, -1.5 + 3 * u, 6.0 * v]
            c = [0.1, 0.4 + 0.4 * u, 0.6 + 0.4 * v]
        pts.append(p)
        cols.append(c)
    pts = np.array(pts)
    cols = np.array(cols)
    free_pts = rng.uniform([-1.5, -1.0, 1.5], [1.5, 1.2, 5.0],
                           size=(n_free, 3))
    free_cols = rng.uniform(0.1, 1.0, size=(n_free, 3))
    means = np.concatenate([pts, free_pts]).astype(np.float32)
    colors = np.concatenate([cols, free_cols]).astype(np.float32)

    scales = np.exp(rng.uniform(-4.3, -3.0, (n_gaussians, 3))).astype(
        np.float32)
    quats = rng.normal(size=(n_gaussians, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    # near-opaque: indoor surfaces are opaque, and a depth sensor reports the
    # surface depth (semi-transparent blobs would front-bias the rendered
    # depth channel)
    opac = rng.uniform(0.90, 0.99, n_gaussians).astype(np.float32)
    return means, scales, quats, opac, colors


def make_trajectory(n_views: int):
    """Camera poses looking into the room from jittered positions near the
    opening (z ~ 0), as (quat wxyz, trans) world-to-camera pairs."""
    poses = []
    for i in range(n_views):
        t_frac = i / max(n_views - 1, 1)
        center = np.array([
            -1.0 + 2.0 * t_frac + 0.05 * np.sin(11 * t_frac * np.pi),
            0.2 * np.sin(3 * t_frac * np.pi),
            0.3 + 0.2 * (1 - np.cos(5 * t_frac * np.pi)),
        ])
        look = np.array([0.0, 0.0, 4.5]) - center
        look /= np.linalg.norm(look)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, look)
        right /= np.linalg.norm(right)
        up2 = np.cross(look, right)
        # rows of R are camera axes (world->camera)
        R = np.stack([right, up2, look], axis=0)
        q = se3.rotmat_to_quat(torch.as_tensor(R, dtype=torch.float32))
        poses.append((q.numpy(), -R @ center))
    return poses


def render_gt_views(means, scales, quats, opac, colors, poses,
                    camera: Camera, config: RasterConfig | None = None,
                    device="cuda"):
    """Render ground-truth images ((3, H, W) float32 numpy each) for the
    given poses on `device`; returns (keyframes with .image set, images)."""
    if config is None:
        config = RasterConfig(tile=16, compact=2**14, kmax=16, chunk=128)
    dev = torch.device(device)
    args = [torch.as_tensor(np.asarray(x, np.float32), device=dev)
            for x in (means, scales, quats, opac, colors)]
    bg = torch.zeros(3, device=dev)
    images = []
    kfs = []
    with torch.inference_mode():
        for i, (q, t) in enumerate(poses):
            kf = Keyframe(kf_id=i, camera=camera, quat=q, trans=t)
            img = rasterize(
                *args, torch.as_tensor(kf.world_view_transform, device=dev),
                torch.as_tensor(kf.full_proj_transform, device=dev),
                camera.width, camera.height, camera.tan_fovx,
                camera.tan_fovy, bg, config=config)["image"]
            kf.image = img.cpu().numpy()
            images.append(kf.image)
            kfs.append(kf)
    return kfs, images


def seeded_map(mc, n_active: int, seed: int):
    """A random map at the widths of `mc`: anchors as bench.py places them
    (uniform in a 8 x 6 x 11.5 m box in front of the origin, offsets
    N(0, 0.3), features N(0, 0.1), scales 0.05) and decoders drawn from
    U(+-1/sqrt(fan_in)), as numpy arrays."""
    rng = np.random.default_rng(seed)
    cap, k, f = mc.capacity, mc.n_offsets, mc.feat_dim
    rot = np.zeros((cap, 4), np.float32)
    rot[:, 0] = 1.0
    active = np.zeros(cap, bool)
    active[:n_active] = True
    anchors = {
        "anchor": rng.uniform([-4, -3, 0.5], [4, 3, 12], (cap, 3)),
        "offset": rng.normal(0, 0.3, (cap, k, 3)),
        "feat": rng.normal(0, 0.1, (cap, f)),
        "scaling": np.full((cap, 6), np.log(0.05)),
        "rotation": rot,
        "opacity": np.full((cap, 1), np.log(0.1 / 0.9)),
        "active": active,
    }
    anchors = {n: v if v.dtype == bool else v.astype(np.float32)
               for n, v in anchors.items()}

    def linear(d_in, d_out):
        b = 1.0 / np.sqrt(d_in)
        return {"w": rng.uniform(-b, b, (d_in, d_out)).astype(np.float32),
                "b": rng.uniform(-b, b, (d_out,)).astype(np.float32)}

    decoders = {
        "opacity": {"l1": linear(mc.opacity_in, f), "l2": linear(f, k)},
        "cov": {"l1": linear(mc.cov_in, f), "l2": linear(f, 7 * k)},
        "color": {"l1": linear(mc.color_in, f), "l2": linear(f, 3 * k)},
        "appearance": linear(7, mc.appearance_dim),
        "embedding": {"table": rng.normal(
            size=(mc.embedding_dim, mc.appearance_dim)).astype(np.float32)},
    }
    return anchors, decoders
