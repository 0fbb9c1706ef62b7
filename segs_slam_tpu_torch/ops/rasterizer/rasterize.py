"""Top-level differentiable tile rasterizer.

Port of segs_slam_tpu/ops/rasterizer/rasterize.py:

    preprocess (torch autograd)                      forward.cu:154-256
      -> compaction + kmax expansion + (tile, depth) sort
      -> tile blend, kernels K1 / K2 inside one
         autograd.Function (blend.py)                forward.cu:339-452,
                                                     backward.cu:399-557

Gradients reach means3d, scales, rotations, opacities, colours (or SH
coefficients) and mean2d_offset through autograd and that one Function.
"""

from __future__ import annotations

import torch

from segs_slam_tpu_torch.ops.rasterizer.blend import binned_blend
from segs_slam_tpu_torch.ops.rasterizer.preprocess import (
    RasterConfig,
    compute_cov3d,
    preprocess_gaussians,
)
from segs_slam_tpu_torch.utils import tracing


def blend_inputs(proj, opacities, colors, mean2d_offset=None):
    """(feats [NPAY, N], aux) for binned_blend from a GaussianProjection."""
    mean2d = proj.mean2d
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset
    feats = torch.stack([
        mean2d[:, 0], mean2d[:, 1],
        proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
        opacities.reshape(-1),
        colors[:, 0], colors[:, 1], colors[:, 2],
    ])
    aux = {
        "rect_min_x": proj.rect_min[:, 0],
        "rect_min_y": proj.rect_min[:, 1],
        "rect_w": proj.rect_max[:, 0] - proj.rect_min[:, 0],
        "touched": proj.tiles_touched.to(torch.int32),
        "depth": proj.depth,
        "alive": proj.radius > 0,
    }
    return feats, aux


def tiles_to_image(x, tx, ty, b, width, height):
    """[nt, C, b*b] tile-major -> [C, H, W]."""
    c = x.shape[1]
    return (x.reshape(ty, tx, c, b, b).permute(2, 0, 3, 1, 4)
            .reshape(c, ty * b, tx * b)[:, :height, :width])


def project(
    means3d: torch.Tensor,  # (N, 3)
    scales: torch.Tensor,  # (N, 3) linear (already exp'd)
    rotations: torch.Tensor,  # (N, 4) normalized quats (w,x,y,z)
    opacities: torch.Tensor,  # (N,) or (N, 1)
    colors: torch.Tensor,  # (N, 3) precomputed colors
    world_view_transform: torch.Tensor,  # (4, 4) W2C^T
    full_proj_transform: torch.Tensor,  # (4, 4)
    width: int,
    height: int,
    tan_fovx,
    tan_fovy,
    config: RasterConfig = RasterConfig(),
    valid: torch.Tensor | None = None,  # (N,) bool mask for padded buffers
    mean2d_offset: torch.Tensor | None = None,  # (N, 2)
    scale_modifier: float = 1.0,
):
    """The front half of `rasterize`: (GaussianProjection, feats, aux), the
    blends' inputs (see `blend_inputs`)."""
    with tracing.span("render.project"):
        cov3d = compute_cov3d(scales, rotations, scale_modifier)
        proj = preprocess_gaussians(
            means3d, cov3d, world_view_transform, full_proj_transform, width,
            height, tan_fovx, tan_fovy, config, valid_in=valid)
        feats, aux = blend_inputs(proj, opacities, colors, mean2d_offset)
    tracing.count("render.kmax_truncated", proj.kmax_truncated)
    return proj, feats, aux


def blend_projected(proj, feats, aux, bg: torch.Tensor, width: int,
                    height: int, config: RasterConfig) -> dict:
    """The back half of `rasterize`: the differentiable blend of `project`'s
    outputs, as images."""
    tx, ty = config.grid(width, height)
    color, final_t, depth_img, ncontrib, num_instances, num_compact = (
        binned_blend(feats, aux, bg, config, tx, ty))

    b = config.tile
    if config.ksmall:
        num_large = ((torch.clamp(proj.tiles_touched, max=config.kmax)
                      > config.ksmall) & (proj.radius > 0)).sum(
                          dtype=torch.int32)
    else:
        num_large = torch.zeros((), dtype=torch.int32, device=color.device)
    return {
        "image": tiles_to_image(color, tx, ty, b, width, height),
        "radii": proj.radius,
        "final_T": tiles_to_image(final_t, tx, ty, b, width, height)[0],
        "n_contrib": tiles_to_image(ncontrib, tx, ty, b, width, height)[0],
        "depth_map": tiles_to_image(depth_img, tx, ty, b, width, height)[0],
        "num_instances": num_instances,
        "num_compact": num_compact,
        "num_kmax_truncated": proj.kmax_truncated,
        "num_large": num_large,
        "depth": proj.depth,
    }


def rasterize(
    means3d: torch.Tensor,  # (N, 3)
    scales: torch.Tensor,  # (N, 3) linear (already exp'd)
    rotations: torch.Tensor,  # (N, 4) normalized quats (w,x,y,z)
    opacities: torch.Tensor,  # (N,) or (N, 1)
    colors: torch.Tensor,  # (N, 3) precomputed colors
    world_view_transform: torch.Tensor,  # (4, 4) W2C^T
    full_proj_transform: torch.Tensor,  # (4, 4)
    width: int,
    height: int,
    tan_fovx,
    tan_fovy,
    bg: torch.Tensor,  # (3,)
    config: RasterConfig = RasterConfig(),
    valid: torch.Tensor | None = None,  # (N,) bool mask for padded buffers
    mean2d_offset: torch.Tensor | None = None,  # (N, 2)
    scale_modifier: float = 1.0,
    shs: torch.Tensor | None = None,  # (N, K, 3) SH coeffs; overrides colors
    sh_degree: int = 3,
    campos: torch.Tensor | None = None,  # (3,); derived when None
) -> dict:
    """Returns dict with image (3, H, W), radii (N,), final_T, n_contrib,
    depth_map, num_instances, num_compact, num_kmax_truncated, num_large,
    depth; the same keys and layouts as the JAX version. With `shs`, the
    colours are sh_to_color's at the camera position (reference:
    computeColorFromSH, forward.cu:20-71; unused by the reference's live
    renderer but part of its kernels' surface)."""
    if shs is not None:
        from segs_slam_tpu_torch.ops.sh import sh_to_color

        if campos is None:
            # the camera centre: the last row of inv(W2C^T) = (-R^T t, 1)
            campos = torch.linalg.inv(world_view_transform)[3, :3]
        colors = sh_to_color(sh_degree, shs, means3d, campos)
    proj, feats, aux = project(
        means3d, scales, rotations, opacities, colors, world_view_transform,
        full_proj_transform, width, height, tan_fovx, tan_fovy, config,
        valid, mean2d_offset, scale_modifier)
    return blend_projected(proj, feats, aux, bg, width, height, config)


def visible_filter(
    means3d: torch.Tensor,
    scales: torch.Tensor,  # (N, 3) linear
    rotations: torch.Tensor,  # (N, 4) normalized
    world_view_transform: torch.Tensor,
    full_proj_transform: torch.Tensor,
    width: int,
    height: int,
    tan_fovx,
    tan_fovy,
    config: RasterConfig = RasterConfig(),
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Anchor visibility prefilter: radii > 0, no blending (reference:
    GaussianRenderer::prefilter_voxel, src/gaussian_renderer.cpp:131-199)."""
    cov3d = compute_cov3d(scales, rotations, 1.0)
    proj = preprocess_gaussians(
        means3d.detach(), cov3d.detach(), world_view_transform,
        full_proj_transform, width, height, tan_fovx, tan_fovy, config,
        valid_in=valid)
    return proj.radius > 0
