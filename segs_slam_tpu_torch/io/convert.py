"""Carry a map between the JAX package's arrays and the port's modules.

A map file (`.npz`) holds the JAX state's `anchors` and `decoders` as numpy
arrays under flattened names: `anchors.<field>` for the AnchorState fields
and `decoders.<path>` for the decoder parameter tree, e.g.
`decoders.opacity.l1.w`. JAX stores a Linear's `w` as (fan_in, fan_out);
nn.Linear stores (out, in), so `w` is transposed on the way in.

A whole train state (map, decoders, pose rows, Adam moments, densify
statistics, step) converts both ways with train_state_from_jax /
train_state_to_numpy, so that the JAX package and the port can start from
one state and be compared leaf by leaf.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch

from segs_slam_tpu_torch.models.anchors import AnchorState
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.models.decoders import Decoders
from segs_slam_tpu_torch.train.optimizer import AdamState
from segs_slam_tpu_torch.train.step import DensifyStats, TrainState

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


def _torch_leaf(name: str, arr) -> tuple[str, torch.Tensor]:
    """A JAX decoder leaf (flat name) as the nn.Module parameter name and
    layout: `x.w` (in, out) -> `x.weight` (out, in), `x.b` -> `x.bias`."""
    path, _, leaf = name.rpartition(".")
    arr = np.asarray(arr, np.float32)
    if leaf == "w":
        return f"{path}.weight", torch.from_numpy(np.ascontiguousarray(arr.T))
    if leaf == "b":
        return f"{path}.bias", torch.from_numpy(arr.copy())
    return name, torch.from_numpy(arr.copy())


def _jax_leaf(name: str, t: torch.Tensor) -> tuple[str, np.ndarray]:
    """The inverse of _torch_leaf."""
    path, _, leaf = name.rpartition(".")
    arr = t.detach().cpu().numpy()
    if leaf == "weight":
        return f"{path}.w", np.ascontiguousarray(arr.T)
    if leaf == "bias":
        return f"{path}.b", arr
    return name, arr


def _unflatten(flat: dict) -> dict:
    """{"opacity.l1.w": a} -> {"opacity": {"l1": {"w": a}}}."""
    tree = {}
    for name, val in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val
    return tree


def decoders_from_jax(params: dict[str, np.ndarray],
                      device=None) -> Decoders:
    """Decoders holding the given JAX decoder parameters (flat names, see
    flatten_params). The architecture is read from the shapes; the module's
    `config` carries it (capacity left at its default)."""
    dec = Decoders(_config_from_shapes(params),
                   generator=torch.Generator().manual_seed(0))
    dec.load_state_dict(dict(_torch_leaf(n, a) for n, a in params.items()),
                        strict=True)
    return dec.to(device)


def anchors_from_numpy(d: dict[str, np.ndarray], device=None) -> AnchorState:
    """AnchorState from numpy arrays named by its fields (copied: the state
    is updated in place by training)."""
    fields = {}
    for name in ANCHOR_FIELDS:
        dtype = np.bool_ if name == "active" else np.float32
        fields[name] = torch.tensor(np.asarray(d[name], dtype),
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


def _fields(x) -> dict:
    """A mapping, or a NamedTuple (the JAX package's state classes), as a
    dict of its fields."""
    return dict(x) if isinstance(x, Mapping) else x._asdict()


def train_state_from_jax(tree, device=None) -> TrainState:
    """The port's TrainState from the JAX package's TrainState with numpy
    leaves (`jax.tree.map(np.asarray, ts)`) or the same layout as nested
    dicts (what train_state_to_numpy returns): anchors, decoders, the pose
    rows and their EMA, the Adam step and moments (transposed like the
    weights), DensifyStats and the step."""
    t = _fields(tree)
    adam = _fields(t["adam"])

    def tensor(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    def group(tree_):
        g = _fields(tree_)
        return {
            "anchors": {k: torch.tensor(np.asarray(v, np.float32),
                                        device=device)
                        for k, v in _fields(g["anchors"]).items()},
            "decoders": {n: x.to(device) for n, x in (
                _torch_leaf(name, a)
                for name, a in flatten_params(g["decoders"]).items())},
            "pose": tensor(g["pose"]),
        }

    stats = _fields(t["stats"])
    return TrainState(
        anchors=anchors_from_numpy(_fields(t["anchors"]), device),
        decoders=decoders_from_jax(flatten_params(t["decoders"]), device),
        adam=AdamState(step=int(adam["step"]), mu=group(adam["mu"]),
                       nu=group(adam["nu"])),
        stats=DensifyStats(**{
            k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in stats.items()}),
        step=int(t["step"]),
        pose=tensor(t["pose"]),
        pose_ema=tensor(t["pose_ema"]),
    )


def train_state_to_numpy(ts: TrainState) -> dict:
    """The inverse of train_state_from_jax: nested dicts of numpy arrays in
    the JAX TrainState's layout and names (decoder weights (in, out))."""
    np_ = lambda x: x.detach().cpu().numpy()  # noqa: E731

    def group(g):
        return {
            "anchors": {k: np_(v) for k, v in g["anchors"].items()},
            "decoders": _unflatten(dict(
                _jax_leaf(n, x) for n, x in g["decoders"].items())),
            "pose": np_(g["pose"]),
        }

    return {
        "anchors": {f: np_(getattr(ts.anchors, f)) for f in ANCHOR_FIELDS},
        "decoders": _unflatten(dict(
            _jax_leaf(n, x) for n, x in ts.decoders.named_parameters())),
        "adam": {"step": np.int32(ts.adam.step), "mu": group(ts.adam.mu),
                 "nu": group(ts.adam.nu)},
        "stats": {f.name: np_(getattr(ts.stats, f.name))
                  for f in dataclasses.fields(ts.stats)},
        "step": np.int32(ts.step),
        "pose": np_(ts.pose),
        "pose_ema": np_(ts.pose_ema),
    }
