"""Carry a map between the JAX package's arrays and the port's modules.

A map file (`.npz`) holds the JAX state's `anchors` and `decoders` as numpy
arrays under flattened names: `anchors.<field>` for the AnchorState fields
and `decoders.<path>` for the decoder parameter tree, e.g.
`decoders.opacity.l1.w`. JAX stores a Linear's `w` as (fan_in, fan_out);
nn.Linear stores (out, in), so `w` is transposed on the way in.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from segs_slam_tpu_torch.models.anchors import AnchorState
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.models.decoders import Decoders

ANCHOR_FIELDS = ("anchor", "offset", "feat", "scaling", "rotation", "opacity",
                 "active")


def flatten_params(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """{"opacity": {"l1": {"w": a}}} -> {"opacity.l1.w": np.asarray(a)}."""
    flat = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            flat.update(flatten_params(val, name + "."))
        else:
            flat[name] = np.asarray(val)
    return flat


def _config_from_shapes(params: dict[str, np.ndarray]) -> ModelConfig:
    feat_dim = params["opacity.l1.w"].shape[1]
    app = params["appearance.w"].shape[1] if "appearance.w" in params else 0
    extra = {}
    if "embedding.table" in params:
        extra["embedding_dim"] = params["embedding.table"].shape[0]
    return ModelConfig(
        feat_dim=feat_dim,
        n_offsets=params["opacity.l2.w"].shape[1],
        appearance_dim=app,
        add_opacity_dist=params["opacity.l1.w"].shape[0] == feat_dim + 4,
        add_cov_dist=params["cov.l1.w"].shape[0] == feat_dim + 4,
        add_color_dist=params["color.l1.w"].shape[0] == feat_dim + 4 + app,
        use_feat_bank="feat_bank.l1.w" in params,
        **extra,
    )


def decoders_from_jax(params: dict[str, np.ndarray],
                      device=None) -> Decoders:
    """Decoders holding the given JAX decoder parameters (flat names, see
    flatten_params). The architecture is read from the shapes; the module's
    `config` carries it (capacity left at its default)."""
    dec = Decoders(_config_from_shapes(params),
                   generator=torch.Generator().manual_seed(0))
    state = {}
    for name, arr in params.items():
        path, _, leaf = name.rpartition(".")
        if leaf == "w":
            state[f"{path}.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(arr, np.float32).T))
        elif leaf == "b":
            state[f"{path}.bias"] = torch.from_numpy(
                np.asarray(arr, np.float32))
        else:
            state[name] = torch.from_numpy(np.asarray(arr, np.float32))
    dec.load_state_dict(state, strict=True)
    return dec.to(device)


def anchors_from_numpy(d: dict[str, np.ndarray], device=None) -> AnchorState:
    """AnchorState from numpy arrays named by its fields."""
    fields = {}
    for name in ANCHOR_FIELDS:
        dtype = np.bool_ if name == "active" else np.float32
        fields[name] = torch.as_tensor(np.asarray(d[name], dtype),
                                       device=device)
    return AnchorState(**fields)


def save_map(path, anchors: dict, decoders: dict) -> None:
    """Write a map file from numpy anchor fields and a (nested or flat)
    decoder parameter dict."""
    arrays = {f"anchors.{k}": np.asarray(anchors[k]) for k in ANCHOR_FIELDS}
    arrays.update({f"decoders.{k}": v
                   for k, v in flatten_params(decoders).items()})
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_map(path, device=None) -> tuple[AnchorState, Decoders]:
    with np.load(Path(path)) as z:
        anchors = {k[len("anchors."):]: z[k] for k in z.files
                   if k.startswith("anchors.")}
        decoders = {k[len("decoders."):]: z[k] for k in z.files
                    if k.startswith("decoders.")}
    return (anchors_from_numpy(anchors, device),
            decoders_from_jax(decoders, device))
