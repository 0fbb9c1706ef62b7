"""Masked multi-group Adam over nested dicts of tensors.

Port of segs_slam_tpu/train/optimizer.py (reference: one torch Adam with
per-group scheduled learning rates and exp_avg/exp_avg_sq surgery on growth
and pruning, src/gaussian_model.cpp:620-998, :1505-1558, :1769-1823). Not
torch.optim.Adam, which has neither per-row masks nor moment surgery:

  * each leaf gets its learning rate from a function of its path, e.g.
    ("anchors", "offset") or ("decoders", "color.l2.weight");
  * updates can be masked per row (inactive anchor slots receive no update
    and their moments stay as they were);
  * densification surgery is masked writes and row permutations of the
    moments.

Unlike the JAX version, which returns new pytrees, `update`, `reset_rows`
and `permute_rows` work IN PLACE on the given tensors (parameters and
moments), to save the memory of a second copy of the map. eps is the
reference's 1e-15 (torch AdamOptions, gaussian_model.cpp:634).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass
class AdamState:
    step: int  # host-side update count
    mu: dict  # first moments, same nesting as the params
    nu: dict  # second moments


def leaves(tree: dict, prefix: tuple = ()):
    """(path, tensor) pairs of a nested dict, in insertion order."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _zeros_like(tree: dict) -> dict:
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def init(params: dict) -> AdamState:
    return AdamState(step=0, mu=_zeros_like(params), nu=_zeros_like(params))


@torch.no_grad()
def update(
    params: dict,
    grads: dict,
    state: AdamState,
    lr_fn: Callable[[tuple], float],
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
    row_mask_fn: Callable[[tuple], torch.Tensor | None] | None = None,
    mode_fn: Callable[[tuple], str] | None = None,
) -> AdamState:
    """One Adam step, in place on `params` and `state`'s moments.

    lr_fn(path) -> the leaf's learning rate (a float). row_mask_fn(path) ->
    (rows,) bool or None: rows where the update applies. mode_fn(path) ->
    "adam", "sgd" (bias-corrected momentum, nu unused) or "amsmax" (second
    moment a non-decaying running max of g^2); default "adam". The bias
    corrections are float32, as the JAX version computes them."""
    count = state.step + 1
    c = np.float32(count)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** c)
    bc2 = float(np.float32(1.0) - np.float32(b2) ** c)
    for path, p in leaves(params):
        g = _get(grads, path)
        mu, nu = _get(state.mu, path), _get(state.nu, path)
        lr = lr_fn(path)
        mode = mode_fn(path) if mode_fn is not None else "adam"
        mu2 = b1 * mu + (1 - b1) * g
        if mode == "sgd":
            nu2 = nu
            upd = lr * (mu2 / bc1)
        elif mode == "amsmax":
            nu2 = torch.maximum(nu, g * g)
            upd = lr * (mu2 / bc1) / (torch.sqrt(nu2) + eps)
        else:
            nu2 = b2 * nu + (1 - b2) * (g * g)
            upd = lr * (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + eps)
        mask = row_mask_fn(path) if row_mask_fn is not None else None
        if mask is not None:
            m = mask.reshape((-1,) + (1,) * (p.dim() - 1))
            p.copy_(torch.where(m, p - upd, p))
            mu.copy_(torch.where(m, mu2, mu))
            nu.copy_(torch.where(m, nu2, nu))
        else:
            p.sub_(upd)
            mu.copy_(mu2)
            nu.copy_(nu2)
    state.step = count
    return state


def _moments(state: AdamState, path_pred: Callable[[tuple], bool]):
    for tree in (state.mu, state.nu):
        for path, x in leaves(tree):
            if path_pred(path):
                yield x


@torch.no_grad()
def reset_rows(state: AdamState, path_pred: Callable[[tuple], bool],
               mask: torch.Tensor) -> AdamState:
    """Zero, in place, the moments on masked rows of the leaves selected by
    path (fresh rows start with zero exp_avg/exp_avg_sq)."""
    for x in _moments(state, path_pred):
        x.masked_fill_(mask.reshape((-1,) + (1,) * (x.dim() - 1)), 0.0)
    return state


@torch.no_grad()
def permute_rows(state: AdamState, path_pred: Callable[[tuple], bool],
                 perm: torch.Tensor) -> AdamState:
    """Apply, in place, a row permutation to the selected leaves' moments
    (prune compaction, the reference's index_select surgery)."""
    for x in _moments(state, path_pred):
        x.copy_(x[perm])
    return state
