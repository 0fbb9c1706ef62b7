"""Dense differentiable blend: O(pixels x gaussians) plain torch.

Port of segs_slam_tpu/ops/rasterizer/dense.py. The same compositing
semantics as the tile blend (accept mask, cumprod closed form, tile
membership from the footprint rects), written as one dense [pixels, N]
computation so that autograd gives reference gradients for the tests of the
blend's backward. Only for tiny scenes; nothing on the main path calls it.

Autograd differentiates the 0.99 alpha clamp, which the blend backward (like
the reference's) leaves out, so the two agree only where no alpha reaches
the clamp.
"""

from __future__ import annotations

import torch

from segs_slam_tpu_torch.ops.rasterizer.preprocess import (
    RasterConfig,
    compute_cov3d,
    preprocess_gaussians,
)


def rasterize_dense(means3d, scales, rotations, opacities, colors,
                    world_view_transform, full_proj_transform, width, height,
                    tan_fovx, tan_fovy, bg,
                    config: RasterConfig = RasterConfig(), valid=None,
                    mean2d_offset=None) -> dict:
    """image (3, H, W), final_T and depth_map (H, W), radii (N,)."""
    opacities = opacities.reshape(-1)
    cov3d = compute_cov3d(scales, rotations, 1.0)
    proj = preprocess_gaussians(
        means3d, cov3d, world_view_transform, full_proj_transform, width,
        height, tan_fovx, tan_fovy, config, valid_in=valid)
    mean2d = proj.mean2d
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset

    # Stable global depth order; restricted per tile it equals the
    # (tile, depth) instance order of the binning.
    order = torch.argsort(proj.depth, stable=True)
    mean2d_s = mean2d[order]
    conic_s = proj.conic[order]
    op_s = opacities[order]
    col_s = colors[order]
    rect_min_s = proj.rect_min[order]
    rect_max_s = proj.rect_max[order]
    alive_s = proj.radius[order] > 0

    dev = means3d.device
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    px = xs.reshape(-1, 1)  # [P, 1]
    py = ys.reshape(-1, 1)
    tile_x = (px // config.tile).to(torch.int32)
    tile_y = (py // config.tile).to(torch.int32)
    member = (alive_s[None, :]
              & (tile_x >= rect_min_s[None, :, 0])
              & (tile_x < rect_max_s[None, :, 0])
              & (tile_y >= rect_min_s[None, :, 1])
              & (tile_y < rect_max_s[None, :, 1]))  # [P, N]

    dx = mean2d_s[None, :, 0] - px
    dy = mean2d_s[None, :, 1] - py
    a, b, c = conic_s[:, 0], conic_s[:, 1], conic_s[:, 2]
    power = -0.5 * (a[None] * dx * dx + c[None] * dy * dy) - b[None] * dx * dy
    alpha = torch.minimum(op_s[None] * torch.exp(power),
                          torch.tensor(config.alpha_clamp, device=dev))
    ok = member & (power <= 0.0) & (alpha >= config.alpha_min)
    alpha = torch.where(ok, alpha, 0.0)

    om = 1.0 - alpha
    cum = torch.cumprod(om, dim=1)
    accept = cum >= config.transmittance_min  # T_in = 1
    t_before = cum / om
    w = torch.where(accept, alpha * t_before, 0.0)  # [P, N]
    color = w @ col_s  # [P, 3]
    depth_map = w @ proj.depth[order]  # expected depth sum_i w_i d_i
    final_t = torch.prod(torch.where(accept, om, 1.0), dim=1)
    color = color + final_t[:, None] * bg[None, :]
    return {
        "image": color.T.reshape(3, height, width),
        "final_T": final_t.reshape(height, width),
        "depth_map": depth_map.reshape(height, width),
        "radii": proj.radius,
    }
