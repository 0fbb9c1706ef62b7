"""Fixed-capacity anchor state.

Port of segs_slam_tpu/models/anchors.py. The map lives in one padded set of
tensors with an active mask (reference parameter groups:
include/gaussian_model.h:242-309):

  anchor (cap,3)  offset (cap,K,3)  feat (cap,F)
  scaling (cap,6) log-space         rotation (cap,4)  opacity (cap,1) logit

`rotation` and `opacity` never receive gradients in the reference
(src/gaussian_model.cpp:372-373); they are kept for checkpoint parity.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.ops.knn import mean_knn_sq_dist


def inverse_sigmoid(x: float) -> float:
    return math.log(x / (1.0 - x))


@dataclasses.dataclass
class AnchorState:
    anchor: torch.Tensor  # (cap, 3)
    offset: torch.Tensor  # (cap, K, 3)
    feat: torch.Tensor  # (cap, F)
    scaling: torch.Tensor  # (cap, 6) log-space
    rotation: torch.Tensor  # (cap, 4)
    opacity: torch.Tensor  # (cap, 1) logit
    active: torch.Tensor  # (cap,) bool

    @property
    def capacity(self) -> int:
        return self.anchor.shape[0]

    @property
    def n_offsets(self) -> int:
        return self.offset.shape[1]

    def num_active(self) -> torch.Tensor:
        return self.active.sum(dtype=torch.int32)

    def params(self) -> dict:
        """The trainable subset, mirroring the reference's anchor param
        groups (trainingSetup, src/gaussian_model.cpp:636-652)."""
        return {name: getattr(self, name) for name in PARAM_FIELDS}

    def replace_params(self, p: dict) -> "AnchorState":
        return dataclasses.replace(self, **{n: p[n] for n in PARAM_FIELDS})


PARAM_FIELDS = ("anchor", "offset", "feat", "scaling", "rotation", "opacity")


def empty_state(config: ModelConfig, device=None) -> AnchorState:
    cap, k, f = config.capacity, config.n_offsets, config.feat_dim
    rot = torch.zeros((cap, 4), dtype=torch.float32, device=device)
    rot[:, 0] = 1.0
    return AnchorState(
        anchor=torch.zeros((cap, 3), dtype=torch.float32, device=device),
        offset=torch.zeros((cap, k, 3), dtype=torch.float32, device=device),
        feat=torch.zeros((cap, f), dtype=torch.float32, device=device),
        scaling=torch.zeros((cap, 6), dtype=torch.float32, device=device),
        rotation=rot,
        opacity=torch.full((cap, 1), inverse_sigmoid(0.1),
                           dtype=torch.float32, device=device),
        active=torch.zeros((cap,), dtype=torch.bool, device=device),
    )


def voxelize(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """Round to the voxel grid and deduplicate, on the host
    (reference: src/gaussian_model.cpp:344-346)."""
    scaled = np.round(np.asarray(points, np.float64) / voxel_size)
    uniq = np.unique(scaled, axis=0)
    return (uniq * voxel_size).astype(np.float32)


def insert_points(state: AnchorState, points: np.ndarray,
                  config: ModelConfig) -> tuple[AnchorState, int]:
    """Voxelize `points` and append the fused cloud into free slots.

    Mirrors createFromPcd / increasePcd: scales = log sqrt(mean 3-NN squared
    distance), identity rotations, logit(0.1) opacity, zero offsets and
    features. As in the JAX version, the existing active anchors count as
    neighbour candidates. Returns (new_state, n_inserted); points beyond the
    remaining capacity are dropped. The input state is left unchanged.
    """
    fused = voxelize(points, config.voxel_size)
    n_active = int(state.num_active())
    n_new = min(fused.shape[0], state.capacity - n_active)
    if n_new <= 0:
        return state, 0
    fused = fused[:n_new]

    dev = state.anchor.device
    new = torch.as_tensor(fused, device=dev)
    cloud = torch.cat([new, state.anchor[:n_active]])
    dist2 = mean_knn_sq_dist(cloud)[:n_new]
    # With fewer than k+1 points the mean is inf: fall back to a voxel-sized
    # scale so tiny initial clouds do not get inf log-scales.
    dist2 = torch.where(torch.isfinite(dist2), dist2, config.voxel_size**2)
    dist2 = torch.clamp(dist2, min=1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].expand(n_new, 6)

    sl = slice(n_active, n_active + n_new)
    out = dataclasses.replace(
        state, **{f.name: getattr(state, f.name).clone()
                  for f in dataclasses.fields(state)})
    out.anchor[sl] = new
    out.scaling[sl] = scales
    out.rotation[sl] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    out.opacity[sl] = inverse_sigmoid(0.1)
    out.offset[sl] = 0.0
    out.feat[sl] = 0.0
    out.active[sl] = True
    return out, n_new
