"""Checkpoint / resume and the shutdown artifacts.

Port of segs_slam_tpu/io/checkpoint.py. The reference only saves at
shutdown (PLY + plain-text MLP dumps + cameras.json, no optimizer state, no
resume; reference: GaussianModel::save_mlp_checkpoints
src/gaussian_model.cpp:1262-1317, GaussianMapper::savePly :2127-2226).
Here:

  * full mid-training resume: the whole TrainState (anchors, decoders, pose
    rows, Adam moments, densify statistics, step) with torch.save, where the
    JAX package uses orbax;
  * artifacts for parity: anchor PLY (io/ply.py), plain-text MLP weight
    dumps in the reference's layout (the same files as the JAX package
    writes for the same weights), and a cameras.json for 3DGS viewers.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from segs_slam_tpu_torch.io.convert import _jax_leaf, _unflatten
from segs_slam_tpu_torch.models.decoders import Decoders
from segs_slam_tpu_torch.train.step import TrainState


def save_train_state(path: str | Path, state: TrainState) -> None:
    """The whole TrainState in one file (tensors saved where they live)."""
    torch.save(state, Path(path))


def load_train_state(path: str | Path, device=None) -> TrainState:
    """The TrainState save_train_state wrote, on `device` (default: where it
    was saved)."""
    return torch.load(Path(path), map_location=device, weights_only=False)


def save_mlp_checkpoints_txt(out_dir: str | Path, decoders: Decoders) -> None:
    """Plain-text W/b dumps per layer, mirroring save_mlp_checkpoints
    (reference: src/gaussian_model.cpp:1262-1317): one file per tensor,
    5-decimal fixed-point rows, each weight as (out, in), which is
    nn.Linear's own layout (the JAX package transposes its (in, out))."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def dump(name: str, arr: np.ndarray) -> None:
        a = np.asarray(arr)
        if a.ndim == 1:
            a = a[None, :]
        with open(out_dir / f"{name}.txt", "w") as f:
            for row in a:
                f.write(" ".join(f"{v:.5f}" for v in row) + "\n")

    # the JAX parameter tree ({"opacity": {"l1": {"w": (in, out), ...}}})
    tree = _unflatten(dict(_jax_leaf(n, x)
                           for n, x in decoders.named_parameters()))
    for mlp_name, layers in tree.items():
        if mlp_name == "embedding":
            dump("embedding_appearance", layers["table"])
            continue
        if "w" in layers:  # single linear (appearance)
            dump(f"mlp_{mlp_name}_weight", layers["w"].T)
            dump(f"mlp_{mlp_name}_bias", layers["b"])
            continue
        for lname, lin in layers.items():
            dump(f"mlp_{mlp_name}_{lname}_weight", lin["w"].T)
            dump(f"mlp_{mlp_name}_{lname}_bias", lin["b"])


def save_cameras_json(path: str | Path, keyframes: dict) -> None:
    """3DGS-viewer-compatible cameras.json
    (reference: GaussianMapper::saveModelParams/keyframesToJson,
    src/gaussian_mapper.cpp:2147-2226)."""
    entries = []
    for i, (kid, kf) in enumerate(sorted(keyframes.items())):
        R = kf.rotation_matrix()
        center = -R.T @ kf.trans
        entries.append({
            "id": int(i),
            "img_name": str(kid),
            "width": kf.camera.width,
            "height": kf.camera.height,
            "position": [float(x) for x in center],
            "rotation": [[float(x) for x in row] for row in R.T],
            "fx": float(kf.camera.fx),
            "fy": float(kf.camera.fy),
        })
    with open(path, "w") as f:
        json.dump(entries, f)


def save_cfg_args(path: str | Path, model_config, white_background: bool,
                  source_path: str = "") -> None:
    """The namespace-string cfg_args file 3DGS tooling expects
    (reference: src/gaussian_mapper.cpp:2228-2246)."""
    text = (
        "Namespace(eval=False, images='images', model_path='"
        + str(Path(path).parent)
        + f"', n_offsets={model_config.n_offsets}, "
        f"feat_dim={model_config.feat_dim}"
        + f", resolution=-1, sh_degree=3, source_path='{source_path}'"
        + f", white_background={white_background})"
    )
    Path(path).write_text(text)
