"""Anchor-state PLY export/import (Scaffold-GS-compatible layout).

A copy of segs_slam_tpu/io/ply.py (numpy only).

Mirrors GaussianModel::savePly/loadPly (reference:
src/gaussian_model.cpp:1054-1261) with one divergence, on purpose: the
reference WRITES properties named `anchor_feat_i` / `offset_i` but its own
loader (and the Scaffold-GS ecosystem) READS `f_anchor_feat_i` /
`f_offset_i`, so its checkpoints do not round-trip. We write the loadable
names and accept both on read.

Offsets are stored planar ([3, K] per anchor: all x's, all y's, all z's),
matching the reference's transpose(1, 2).flatten(1).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def save_anchor_ply(
    path: str | Path,
    anchor: np.ndarray,  # (n, 3)
    feat: np.ndarray,  # (n, F)
    offset: np.ndarray,  # (n, K, 3)
    opacity: np.ndarray,  # (n, 1) logit
    scaling: np.ndarray,  # (n, 6) log
    rotation: np.ndarray,  # (n, 4)
) -> None:
    n = anchor.shape[0]
    fdim = feat.shape[1]
    k = offset.shape[1]
    offset_planar = np.transpose(offset, (0, 2, 1)).reshape(n, 3 * k)

    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_anchor_feat_{i}" for i in range(fdim)]
    names += [f"f_offset_{i}" for i in range(3 * k)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(6)]
    names += [f"rot_{i}" for i in range(4)]

    data = np.concatenate(
        [
            anchor.astype(np.float32),
            np.zeros((n, 3), np.float32),
            feat.astype(np.float32),
            offset_planar.astype(np.float32),
            opacity.reshape(n, 1).astype(np.float32),
            scaling.astype(np.float32),
            rotation.astype(np.float32),
        ],
        axis=1,
    )
    assert data.shape[1] == len(names)

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {nm}" for nm in names]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.astype("<f4").tobytes())


def load_anchor_ply(path: str | Path) -> dict:
    """Returns dict(anchor, feat, offset (n,K,3), opacity, scaling, rotation)."""
    with open(path, "rb") as f:
        names = []
        n = 0
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float"):
                names.append(line.split()[-1])
            elif line.startswith("property"):
                raise ValueError(f"unsupported property type: {line}")
            elif line == "end_header":
                break
        data = np.frombuffer(f.read(4 * n * len(names)), dtype="<f4").reshape(
            n, len(names)
        )
    col = {nm: i for i, nm in enumerate(names)}

    def grab(prefixes):
        for p in prefixes:
            idxs = []
            i = 0
            while f"{p}{i}" in col:
                idxs.append(col[f"{p}{i}"])
                i += 1
            if idxs:
                return data[:, idxs]
        raise KeyError(f"no properties with prefixes {prefixes}")

    anchor = data[:, [col["x"], col["y"], col["z"]]]
    feat = grab(["f_anchor_feat_", "anchor_feat_"])
    offset_planar = grab(["f_offset_", "offset_"])
    k = offset_planar.shape[1] // 3
    offset = np.transpose(offset_planar.reshape(n, 3, k), (0, 2, 1))
    opacity = data[:, [col["opacity"]]]
    scaling = grab(["scale_"])
    rotation = grab(["rot_"])
    return {
        "anchor": anchor,
        "feat": feat,
        "offset": offset,
        "opacity": opacity,
        "scaling": scaling,
        "rotation": rotation,
    }
