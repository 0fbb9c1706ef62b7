"""Anchor -> neural Gaussian decoding over the fixed-capacity state.

Port of segs_slam_tpu/models/neural_gaussians.py (reference:
src/gaussian_renderer.cpp:214-334 generate_neural_gaussians). Every capacity
slot is decoded, and masks take the place of the reference's gathers:

  * the visibility prefilter mask (anchor radii > 0) and the active mask
    gate which anchors' gaussians are valid;
  * the neural-opacity > 0 mask (the reference's `mask`) joins them in the
    per-gaussian `valid` fed to the rasterizer.

Outputs are flat [cap*K] arrays in (anchor-major, offset) order, the
reference's reshape({-1, ...}) layout.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from segs_slam_tpu_torch.models.anchors import AnchorState
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.models.decoders import Decoders


class NeuralGaussians(NamedTuple):
    xyz: torch.Tensor  # (cap*K, 3)
    color: torch.Tensor  # (cap*K, 3)
    opacity: torch.Tensor  # (cap*K,)
    scaling: torch.Tensor  # (cap*K, 3) linear
    rotation: torch.Tensor  # (cap*K, 4) normalized
    valid: torch.Tensor  # (cap*K,) bool: active & visible & opacity > 0
    neural_opacity: torch.Tensor  # (cap*K,) raw tanh output (for stats)
    offset_mask: torch.Tensor  # (cap*K,) bool: the reference's `mask`


def generate_neural_gaussians(
    state: AnchorState,
    decoders: Decoders,
    camera_center: torch.Tensor,  # (3,)
    pose7: torch.Tensor,  # (7,) tx,ty,tz,qw,qx,qy,qz
    visible_mask: torch.Tensor,  # (cap,) bool from the voxel prefilter
    config: ModelConfig,
) -> NeuralGaussians:
    cap, k = state.capacity, config.n_offsets

    feat = state.feat
    anchor = state.anchor
    grid_scaling = torch.exp(state.scaling)  # (cap, 6)

    ob_view = anchor - camera_center[None, :]
    # safe norm: zero-padded slots can sit exactly on the camera centre
    ob_dist = torch.sqrt(
        torch.sum(ob_view * ob_view, dim=-1, keepdim=True) + 1e-12)
    ob_view = ob_view / ob_dist

    if config.use_feat_bank:
        # reference: src/gaussian_renderer.cpp:236-249: blend the feature at
        # 3 decimations (::4, ::2, ::1) with softmax weights
        bank = decoders.decode_feat_bank(torch.cat([ob_view, ob_dist], -1))
        nf = feat.shape[1]
        f4 = torch.repeat_interleave(feat[:, ::4], 4, dim=1)[:, :nf]
        f2 = torch.repeat_interleave(feat[:, ::2], 2, dim=1)[:, :nf]
        feat = f4 * bank[:, 0:1] + f2 * bank[:, 1:2] + feat * bank[:, 2:3]

    cat_local = torch.cat([feat, ob_view], dim=-1)
    cat_local_dist = torch.cat([feat, ob_view, ob_dist], dim=-1)

    op_in = cat_local_dist if config.add_opacity_dist else cat_local
    neural_opacity = decoders.decode_opacity(op_in)  # (cap, K)
    offset_mask = neural_opacity > 0.0

    color_in = cat_local_dist if config.add_color_dist else cat_local
    if config.appearance_dim > 0:
        # pose-conditioned appearance code (gaussian_renderer.cpp:256-270)
        app = decoders.decode_appearance(pose7[None, :])  # (1, A)
        color_in = torch.cat([color_in, app.expand(cap, -1)], dim=-1)
    color = decoders.decode_color(color_in).reshape(cap * k, 3)

    cov_in = cat_local_dist if config.add_cov_dist else cat_local
    scale_rot = decoders.decode_cov(cov_in).reshape(cap * k, 7)

    # xyz = anchor + offset * scaling[:3]; scaling = scaling[3:] * sigmoid(sr)
    # (reference: src/gaussian_renderer.cpp:301-333)
    scaling = (torch.repeat_interleave(grid_scaling[:, 3:6], k, dim=0)
               * torch.sigmoid(scale_rot[:, :3]))
    rot_raw = scale_rot[:, 3:7]
    rot = rot_raw / torch.sqrt(
        torch.sum(rot_raw * rot_raw, dim=-1, keepdim=True) + 1e-24)

    offsets = state.offset.reshape(cap * k, 3)
    xyz = (torch.repeat_interleave(anchor, k, dim=0)
           + offsets * torch.repeat_interleave(grid_scaling[:, 0:3], k, dim=0))

    active_k = torch.repeat_interleave(state.active & visible_mask, k, dim=0)
    valid = active_k & offset_mask.reshape(-1)

    return NeuralGaussians(
        xyz=xyz,
        color=color,
        opacity=neural_opacity.reshape(-1),
        scaling=scaling,
        rotation=rot,
        valid=valid,
        neural_opacity=neural_opacity.reshape(-1),
        offset_mask=offset_mask.reshape(-1),
    )
