"""Anchor densification: multi-level voxel growth + opacity pruning.

Port of segs_slam_tpu/train/densify.py (reference: GaussianModel::
adjust_anchor / anchor_growing / prune_anchor, src/gaussian_model.cpp:
1505-1762) on the fixed-capacity state:

  * growth per level: threshold + random candidate selection, voxel dedup
    and existing-anchor-cell rejection in one lexicographic sort over
    [anchor cells ++ candidate cells] (anchors sort first within a cell),
    feature init by a segment max over candidate cellmates;
  * new anchors go into free slots, with zero Adam moments and stats;
  * prune clears the active mask, then a stable compaction permutation keeps
    active slots contiguous;
  * the reference's scaling clamp quirk: every prune pass clamps
    log-scaling[:, 3:] to <= 0.05 for all anchors (:1525-1532).

The JAX version's 4-key lax.sort becomes stable sorts from the least
significant key up. Its random keep-masks come from jax.random; here they
come from a torch.Generator (`make_adjust_anchor`) or are passed in
(`adjust_anchor`), which is how the tests feed both versions JAX's masks.
Runs every update_interval iterations; not latency critical.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from segs_slam_tpu_torch.models.anchors import AnchorState, inverse_sigmoid
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.ops.rasterizer.preprocess import to_int32
from segs_slam_tpu_torch.train import optimizer
from segs_slam_tpu_torch.train.config import OptimizationConfig
from segs_slam_tpu_torch.train.step import DensifyStats, TrainState
from segs_slam_tpu_torch.utils import tracing

_SENTINEL = 2**30


def _anchor_path(path) -> bool:
    return path[0] == "anchors"


def keep_probability(level: int) -> float:
    """Chance that a candidate of growth level `level` is drawn."""
    return 1.0 - 0.5 ** (level + 1)


def _lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic order of rows by keys[0], then keys[1], ...
    (lax.sort with num_keys=len(keys), is_stable=True)."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


@torch.no_grad()
def _grow_level(ts: TrainState, level: int, cand_base, cand_xyz, cand_feat,
                rand_keep, model_config: ModelConfig,
                opt_config: OptimizationConfig, grads_norm) -> None:
    """One growth level, in place on ts. rand_keep: (CK,) bool, the level's
    random candidate draw."""
    cap = model_config.capacity
    ck = cand_xyz.shape[0]
    fdim = cand_feat.shape[1]
    dev = cand_xyz.device

    thr = opt_config.densify_grad_threshold * (
        math.floor(model_config.update_hierachy_factor / 2) ** level)
    size_factor = int(model_config.update_init_factor
                      / (model_config.update_hierachy_factor**level))
    cur_size = model_config.voxel_size * size_factor
    cand = cand_base & (grads_norm >= thr) & rand_keep

    anchors = ts.anchors
    active = anchors.active
    n_active = active.sum(dtype=torch.int32)

    # Cells: anchors first (tag 0), candidates second (tag 1).
    a_cell = to_int32(torch.round(anchors.anchor / cur_size))
    c_cell = to_int32(torch.round(cand_xyz / cur_size))
    cells = torch.cat([a_cell, c_cell])
    tag = torch.cat([torch.zeros(cap, dtype=torch.int32, device=dev),
                     torch.ones(ck, dtype=torch.int32, device=dev)])
    row_valid = torch.cat([active, cand])
    cells = torch.where(row_valid[:, None], cells, _SENTINEL)

    src = _lexsort([cells[:, 0], cells[:, 1], cells[:, 2], tag])
    cs, tg = cells[src], tag[src]
    new_cell = torch.ones(cap + ck, dtype=torch.bool, device=dev)
    new_cell[1:] = (cs[1:] != cs[:-1]).any(dim=1)
    keep = (tg == 1) & new_cell & (cs[:, 0] < _SENTINEL)

    # Per-cell feature max over CANDIDATE cellmates (anchors excluded).
    seg_id = torch.cumsum(new_cell.long(), 0) - 1
    feat_all = torch.cat([torch.full((cap, fdim), -math.inf, device=dev),
                          cand_feat])
    feat_sorted = torch.where((tg == 1)[:, None], feat_all[src], -math.inf)
    seg_max = torch.full((cap + ck, fdim), -math.inf, device=dev)
    seg_max.scatter_reduce_(0, seg_id[:, None].expand(-1, fdim), feat_sorted,
                            "amax")
    kept_feat = seg_max[seg_id]
    kept_feat = torch.where(torch.isfinite(kept_feat), kept_feat, 0.0)

    # Destination slots for kept candidates; the rest past capacity drop.
    rank = torch.cumsum(keep.int(), 0) - 1
    dest = torch.where(keep, n_active + rank, cap)
    sel = dest < cap
    d = dest[sel].long()

    anchors.anchor[d] = cs[sel].float() * cur_size
    anchors.scaling[d] = math.log(cur_size)
    anchors.rotation[d] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    anchors.opacity[d] = inverse_sigmoid(0.1)
    anchors.feat[d] = kept_feat[sel]
    anchors.offset[d] = 0.0
    activated = torch.zeros(cap, dtype=torch.bool, device=dev)
    activated[d] = keep[sel]
    anchors.active |= activated

    # Fresh slots start with zero Adam moments and zero stats.
    optimizer.reset_rows(ts.adam, _anchor_path, activated)
    st = ts.stats
    for x in (st.opacity_accum, st.anchor_demon, st.offset_grad_accum,
              st.offset_denom):
        x.masked_fill_(activated.reshape((-1,) + (1,) * (x.dim() - 1)), 0.0)


@torch.no_grad()
def adjust_anchor(ts: TrainState, rand_keeps: list[torch.Tensor],
                  model_config: ModelConfig,
                  opt_config: OptimizationConfig) -> TrainState:
    """Grow (one level per entry of rand_keeps, each a (cap*K,) bool
    candidate draw) and prune, in place on ts; returns ts."""
    cap, k = model_config.capacity, model_config.n_offsets
    oc = opt_config
    if len(rand_keeps) != model_config.update_depth:
        raise ValueError(f"need {model_config.update_depth} keep masks, got "
                         f"{len(rand_keeps)}")
    stats = ts.stats
    denom = stats.offset_denom
    grads = stats.offset_grad_accum / torch.where(denom == 0, 1.0, denom)
    grads = torch.where(denom == 0, 0.0, grads)
    grads_norm = grads.abs().reshape(-1)  # (CK,)
    offset_mask = (denom > oc.update_interval * oc.success_threshold * 0.5
                   ).reshape(-1)

    a = ts.anchors
    traced = tracing.enabled()
    if traced:  # the active anchors before growth
        n_before = a.active.sum(dtype=torch.int32)
    scale3 = torch.exp(a.scaling[:, :3])
    cand_xyz = (a.anchor[:, None, :] + a.offset * scale3[:, None, :]
                ).reshape(-1, 3)
    cand_feat = torch.repeat_interleave(a.feat, k, dim=0)
    cand_base = offset_mask & torch.repeat_interleave(a.active, k)
    for level, rand_keep in enumerate(rand_keeps):
        _grow_level(ts, level, cand_base, cand_xyz, cand_feat, rand_keep,
                    model_config, oc, grads_norm)

    # Reset the accumulators that passed the offset_mask threshold
    # (reference: adjust_anchor, src/gaussian_model.cpp:1714-1724).
    om = offset_mask.reshape(cap, k)
    stats.offset_denom.masked_fill_(om, 0.0)
    stats.offset_grad_accum.masked_fill_(om, 0.0)

    # Prune (reference: :1726-1759).
    active = ts.anchors.active
    anchors_mask = stats.anchor_demon > oc.update_interval * \
        oc.success_threshold
    prune = ((stats.opacity_accum < oc.min_opacity * stats.anchor_demon)
             & anchors_mask & active)
    # stats reset for well-observed anchors, pruned or not
    stats.opacity_accum.masked_fill_(anchors_mask | prune, 0.0)
    stats.anchor_demon.masked_fill_(anchors_mask | prune, 0.0)
    stats.offset_denom.masked_fill_(prune[:, None], 0.0)
    stats.offset_grad_accum.masked_fill_(prune[:, None], 0.0)

    new_active = active & ~prune
    if traced:
        tracing.count("densify.adjusts", 1)
        tracing.count("densify.grown", active.sum(dtype=torch.int32)
                      - n_before)
        tracing.count("densify.pruned", prune.sum(dtype=torch.int32))
    scaling = ts.anchors.scaling.clone()
    scaling[:, 3:] = torch.clamp(scaling[:, 3:], max=0.05)

    # Compaction: stable partition active-first, applied to every
    # per-anchor row array (params, moments, stats).
    perm = torch.sort((~new_active).int(), stable=True).indices
    ts.anchors = AnchorState(
        anchor=a.anchor[perm], offset=a.offset[perm], feat=a.feat[perm],
        scaling=scaling[perm], rotation=a.rotation[perm],
        opacity=a.opacity[perm], active=new_active[perm])
    optimizer.permute_rows(ts.adam, _anchor_path, perm)
    # pruned rows keep stale values but active=False; zero their moments so
    # that re-activation starts clean
    optimizer.reset_rows(ts.adam, _anchor_path, ~ts.anchors.active)
    ts.stats = DensifyStats(**{f.name: getattr(stats, f.name)[perm]
                               for f in dataclasses.fields(stats)})
    return ts


def make_adjust_anchor(model_config: ModelConfig,
                       opt_config: OptimizationConfig):
    """adjust(ts, generator) -> ts: adjust_anchor with the keep masks drawn
    as uniform [0, 1) <= keep_probability(level) from `generator` (a
    torch.Generator on the state's device)."""
    ck = model_config.capacity * model_config.n_offsets

    def adjust(ts: TrainState, generator: torch.Generator) -> TrainState:
        dev = ts.anchors.anchor.device
        keeps = [torch.rand(ck, generator=generator, device=dev)
                 <= keep_probability(level)
                 for level in range(model_config.update_depth)]
        return adjust_anchor(ts, keeps, model_config, opt_config)

    return adjust
