"""Full-model render: prefilter -> neural-gaussian decode -> rasterize.

Port of segs_slam_tpu/models/renderer.py:render (reference:
src/gaussian_renderer.cpp:19-199 GaussianRenderer::render +
prefilter_voxel). The eval renderers of the JAX module (EvalRenderer,
calibrate_eval_config, ChainedEvalRenderer) belong to the eval slice and are
not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from segs_slam_tpu_torch.models.anchors import AnchorState
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.models.decoders import Decoders
from segs_slam_tpu_torch.models.neural_gaussians import (
    NeuralGaussians,
    generate_neural_gaussians,
)
from segs_slam_tpu_torch.ops.rasterizer import (
    RasterConfig,
    rasterize,
    visible_filter,
)


class RenderOutput(NamedTuple):
    image: torch.Tensor  # (3, H, W)
    radii: torch.Tensor  # (cap*K,)
    visibility_filter: torch.Tensor  # (cap*K,) bool: radii > 0
    neural: NeuralGaussians
    visible_anchor_mask: torch.Tensor  # (cap,)
    num_instances: torch.Tensor
    num_compact: torch.Tensor  # () int32: visible gaussians before the
    #   static `compact` cap (overflow drops the faintest)
    num_kmax_truncated: torch.Tensor  # () int32: footprints shrunk to kmax
    depth_map: torch.Tensor  # (H, W) expected depth sum_i w_i d_i (NOT
    #   alpha-normalised; divide by 1 - final_T to compare with sensor depth)
    final_T: torch.Tensor  # (H, W) remaining transmittance


def neural_gaussians_for_view(
    state: AnchorState,
    decoders: Decoders,
    cam: dict,
    width: int,
    height: int,
    model_config: ModelConfig,
    raster_config: RasterConfig,
) -> tuple[torch.Tensor, NeuralGaussians]:
    """The anchor visibility prefilter and the decode of the visible anchors'
    gaussians for one view: (visible_anchor_mask, NeuralGaussians)."""
    # prefilter_voxel uses the anchors with scaling[:, :3] and normalized
    # rotations
    grid_scale3 = torch.exp(state.scaling[:, :3])
    rotation = state.rotation / torch.clamp(
        torch.linalg.norm(state.rotation, dim=-1, keepdim=True), min=1e-12)
    visible = visible_filter(
        state.anchor, grid_scale3, rotation,
        cam["world_view_transform"], cam["full_proj_transform"],
        width, height, cam["tan_fovx"], cam["tan_fovy"],
        config=raster_config, valid=state.active)
    neural = generate_neural_gaussians(
        state, decoders, cam["camera_center"], cam["pose7"], visible,
        model_config)
    return visible, neural


def render(
    state: AnchorState,
    decoders: Decoders,
    cam: dict,  # keyframe render_inputs() as tensors on the render device
    width: int,
    height: int,
    bg: torch.Tensor,
    model_config: ModelConfig,
    raster_config: RasterConfig,
    mean2d_offset: torch.Tensor | None = None,
) -> RenderOutput:
    visible, neural = neural_gaussians_for_view(
        state, decoders, cam, width, height, model_config, raster_config)
    out = rasterize(
        neural.xyz, neural.scaling, neural.rotation, neural.opacity,
        neural.color, cam["world_view_transform"], cam["full_proj_transform"],
        width, height, cam["tan_fovx"], cam["tan_fovy"], bg,
        config=raster_config, valid=neural.valid,
        mean2d_offset=mean2d_offset)

    return RenderOutput(
        image=out["image"],
        radii=out["radii"],
        visibility_filter=out["radii"] > 0,
        neural=neural,
        visible_anchor_mask=visible,
        num_instances=out["num_instances"],
        num_compact=out["num_compact"],
        num_kmax_truncated=out["num_kmax_truncated"],
        depth_map=out["depth_map"],
        final_T=out["final_T"],
    )
