"""Full-model render: prefilter -> neural-gaussian decode -> rasterize.

Port of segs_slam_tpu/models/renderer.py (reference:
src/gaussian_renderer.cpp:19-199 GaussianRenderer::render +
prefilter_voxel): `render` (the differentiable training render, blend
kernels K1/K2), `EvalRenderer` (the no-gradient eval render over the packed
binning, kernel K3), `calibrate_eval_config`, `ChainedEvalRenderer` (the
eval render as three separable stages) and `project_to_image` (the debug
2-D projection).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from segs_slam_tpu_torch.models.anchors import AnchorState
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.models.decoders import Decoders
from segs_slam_tpu_torch.models.neural_gaussians import (
    NeuralGaussians,
    generate_neural_gaussians,
)
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig, visible_filter
from segs_slam_tpu_torch.ops.rasterizer.blend import (
    binned_blend,
    binned_blend_eval,
)
from segs_slam_tpu_torch.ops.rasterizer.rasterize import (
    blend_projected,
    project,
    tiles_to_image,
)
from segs_slam_tpu_torch.utils import tracing


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
    with tracing.span("render.prefilter"):
        # prefilter_voxel uses the anchors with scaling[:, :3] and
        # normalized rotations
        grid_scale3 = torch.exp(state.scaling[:, :3])
        rotation = state.rotation / torch.clamp(
            torch.linalg.norm(state.rotation, dim=-1, keepdim=True),
            min=1e-12)
        visible = visible_filter(
            state.anchor, grid_scale3, rotation,
            cam["world_view_transform"], cam["full_proj_transform"],
            width, height, cam["tan_fovx"], cam["tan_fovy"],
            config=raster_config, valid=state.active)
    with tracing.span("render.decode"):
        neural = generate_neural_gaussians(
            state, decoders, cam["camera_center"], cam["pose7"], visible,
            model_config)
    return visible, neural


def project_view(state: AnchorState, decoders: Decoders, cam: dict,
                 width: int, height: int, model_config: ModelConfig,
                 raster_config: RasterConfig,
                 mean2d_offset: torch.Tensor | None = None):
    """Prefilter, decode and project one view: (visible_anchor_mask,
    NeuralGaussians, GaussianProjection, feats, aux), the blends' inputs.
    Shared by `render`, `EvalRenderer` and `calibrate_eval_config`."""
    visible, neural = neural_gaussians_for_view(
        state, decoders, cam, width, height, model_config, raster_config)
    proj, feats, aux = project(
        neural.xyz, neural.scaling, neural.rotation, neural.opacity,
        neural.color, cam["world_view_transform"], cam["full_proj_transform"],
        width, height, cam["tan_fovx"], cam["tan_fovy"],
        config=raster_config, valid=neural.valid,
        mean2d_offset=mean2d_offset)
    return visible, neural, proj, feats, aux


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
    visible, neural, proj, feats, aux = project_view(
        state, decoders, cam, width, height, model_config, raster_config,
        mean2d_offset)
    out = blend_projected(proj, feats, aux, bg, width, height, raster_config)

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


class EvalRenderer:
    """The eval render of a map: decode + project + the packed eval blend
    (binned_blend_eval, kernel K3), without gradients. Where the packed
    layouts do not fit the config (RasterConfig.eval_binning), or with
    packed=False, it renders through the training blend (binned_blend,
    kernel K1), as the JAX class does.

    The JAX class fuses the whole render into one jit to save the TPU's
    dispatch costs; here the same ops run eagerly on `device`.
    """

    def __init__(self, model_config: ModelConfig,
                 raster_config: RasterConfig, width: int, height: int,
                 bg: torch.Tensor, packed: bool = True,
                 device: str | torch.device = "cuda"):
        self.model_config, self.raster_config = model_config, raster_config
        self.width, self.height = width, height
        self.device = torch.device(device)
        self.bg = torch.as_tensor(bg, dtype=torch.float32,
                                  device=self.device).reshape(3)
        route = raster_config.eval_binning(
            *raster_config.grid(width, height), packed)
        self.packed = route in ("sel_direct", "f16")

    def _blend(self, feats: torch.Tensor, aux: dict):
        """The view's image (3, H, W), num_instances and num_compact: the
        packed eval blend, or the training blend where it does not fit
        (`packed`). No gradient."""
        rc, w, h = self.raster_config, self.width, self.height
        tx, ty = rc.grid(w, h)
        blend = binned_blend_eval if self.packed else binned_blend
        with torch.no_grad():
            color, *_, num_instances, num_compact = blend(
                feats, aux, self.bg, rc, tx, ty)
        return (tiles_to_image(color, tx, ty, rc.tile, w, h), num_instances,
                num_compact)

    def render_with_counts(self, anchors: AnchorState, decoders: Decoders,
                           cam: dict) -> dict:
        """image (3, H, W) and the view's num_instances, num_compact and
        num_kmax_truncated (device tensors)."""
        with torch.no_grad():
            _, _, proj, feats, aux = project_view(
                anchors, decoders, cam, self.width, self.height,
                self.model_config, self.raster_config)
            image, num_instances, num_compact = self._blend(feats, aux)
        return {"image": image, "num_instances": num_instances,
                "num_compact": num_compact,
                "num_kmax_truncated": proj.kmax_truncated}

    def __call__(self, anchors: AnchorState, decoders: Decoders,
                 cam: dict) -> torch.Tensor:
        """The view's image (3, H, W)."""
        return self.render_with_counts(anchors, decoders, cam)["image"]

    def render_batch(self, anchors: AnchorState, decoders: Decoders,
                     cams_stacked: dict) -> torch.Tensor:
        """(B, 3, H, W) for a stack of cameras (every entry of cams_stacked
        has a leading batch axis): the views rendered one after another.
        The JAX class maps one jit over the stack to pay the TPU's dispatch
        cost once; eager PyTorch has no such cost to amortise, so this is a
        loop kept for the callers' interface."""
        n = next(iter(cams_stacked.values())).shape[0]
        return torch.stack([
            self(anchors, decoders, {k: v[i] for k, v in cams_stacked.items()})
            for i in range(n)])


def calibrate_eval_config(raster_config: RasterConfig,
                          model_config: ModelConfig, anchors: AnchorState,
                          decoders: Decoders, cams: list[dict], width: int,
                          height: int, headroom: float = 2.0) -> RasterConfig:
    """eval_variant's config with the tier prefixes (nmid, nlarge) sized
    from the map's own footprints: on each camera, count the live
    gaussians whose (kmax-clamped) footprint exceeds ksmall and kmid, and
    take `headroom` times the largest count, rounded up to a power of two,
    with eval_variant's sizes as floors and compact as the ceiling. Static
    formula sizes dim real maps whose footprints are heavier than the
    synthetic ones (12 dB measured in the JAX package's history). Returns
    eval_variant's result unchanged where the view does not take the
    direct-selection binning (RasterConfig.eval_binning)."""
    rc = raster_config.eval_variant(width, height)
    if rc.eval_binning(*rc.grid(width, height)) != "sel_direct":
        return rc
    n_mid = n_large = 0
    with torch.no_grad():
        for cam in cams:
            _, neural, proj, _, _ = project_view(
                anchors, decoders, cam, width, height, model_config, rc)
            t = torch.where((proj.radius > 0) & neural.valid,
                            torch.clamp(proj.tiles_touched, max=rc.kmax), 0)
            n_mid = max(n_mid, int((t > rc.ksmall).sum()))
            n_large = max(n_large, int((t > rc.kmid).sum()))

    def pow2(n):
        return 1 << max(0, math.ceil(math.log2(max(n, 1))))

    nmid = min(rc.compact, max(rc.nmid, pow2(int(n_mid * headroom))))
    nlarge = min(nmid, max(rc.nlarge, pow2(int(n_large * headroom))))
    return dataclasses.replace(rc, nmid=nmid, nlarge=nlarge)


class ChainedEvalRenderer(EvalRenderer):
    """EvalRenderer's render as three stages: decode (prefilter + the
    neural-gaussian MLPs) -> project (cov3d + preprocess + the blend's
    feature rows) -> blend (the packed eval binning and K3, or, where the
    packed layouts do not fit or with packed=False, the training blend and
    K1: EvalRenderer's, the JAX class's renderer.py:329-332). Not
    differentiable; EvalRenderer's constructor.

    The JAX class compiles each stage as its own jit, and its `jits()`
    exposes them for the jit caches' introspection; eager PyTorch has no
    jit cache, so there is no `jits()`. The stages are separable for tests
    and for profiling each stage on a real map.
    """

    def decode(self, anchors: AnchorState, decoders: Decoders,
               cam: dict) -> NeuralGaussians:
        with torch.no_grad():
            return neural_gaussians_for_view(
                anchors, decoders, cam, self.width, self.height,
                self.model_config, self.raster_config)[1]

    def project(self, neural: NeuralGaussians, cam: dict):
        """(feats [NPAY, N], aux): the blends' inputs."""
        with torch.no_grad():
            _, feats, aux = project(
                neural.xyz, neural.scaling, neural.rotation, neural.opacity,
                neural.color, cam["world_view_transform"],
                cam["full_proj_transform"], self.width, self.height,
                cam["tan_fovx"], cam["tan_fovy"], config=self.raster_config,
                valid=neural.valid)
        return feats, aux

    def blend(self, feats: torch.Tensor, aux: dict) -> torch.Tensor:
        """The image (3, H, W)."""
        return self._blend(feats, aux)[0]

    def __call__(self, anchors: AnchorState, decoders: Decoders,
                 cam: dict) -> torch.Tensor:
        return self.blend(*self.project(self.decode(anchors, decoders, cam),
                                        cam))


def project_to_image(state: AnchorState, decoders: Decoders, cam: dict,
                     width: int, height: int, model_config: ModelConfig,
                     raster_config: RasterConfig) -> dict:
    """Debug 2-D projection: per neural gaussian its mean2d, radius, colour
    and validity (reference: GaussianRenderer::gaussians_project2_image /
    RasterizeGaussiansprojectCUDA, src/gaussian_renderer.cpp:336-423,
    rasterizer_impl.cu:571-585, the mapper's debug ellipse overlays): the
    preprocess outputs, left on the device."""
    with torch.no_grad():
        _, neural, proj, _, _ = project_view(
            state, decoders, cam, width, height, model_config, raster_config)
    return {
        "points2d": proj.mean2d,
        "radii": proj.radius,
        "color": neural.color,
        "valid": neural.valid & (proj.radius > 0),
    }
