"""Tile binning: priority compaction, kmax / dual-rate expansion, and one
stable (tile, depth) sort.

Port of the training-path half of segs_slam_tpu/ops/rasterizer/binning.py
(reference: cuda_rasterizer/rasterizer_impl.cu:70-138, 276-308). The JAX
version carries every feature through its sorts as payload because gathers
are slow on the TPU; here the sorts carry only indices and the features are
gathered afterwards, which gives the same arrays:

  1. compact: stable sort of a 16-bit opacity-priority key (dead rows last),
     keep the leading `compact` gaussians;
  2. expand each compact gaussian to its tile slots, in the JAX expansion
     order (the small tier [compact, ksmall] row-major, then the nlarge
     largest footprints' remaining slots);
  3. one stable sort on an int64 key (tile << 32 | order-preserving depth
     bits), i.e. lax.sort's (tile, depth) order with ties in expansion order;
  4. tile ranges by searchsorted.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from segs_slam_tpu_torch.ops.rasterizer.preprocess import (
    RasterConfig,
    to_int32,
)

NPAY = 9  # mean2d.x/y, conic a/b/c, opacity, r, g, b
DEAD_KEY = 1 << 24


class CompactGaussians(NamedTuple):
    feats: torch.Tensor  # (NPAY, compact)
    rect_min_x: torch.Tensor
    rect_min_y: torch.Tensor
    rect_w: torch.Tensor
    touched: torch.Tensor
    depth: torch.Tensor
    orig_id: torch.Tensor  # (compact,) index into the original [N] arrays
    valid: torch.Tensor  # (compact,) bool
    num_valid: torch.Tensor  # () int32: true count (may exceed capacity)


class BinnedInstances(NamedTuple):
    feats_sorted: torch.Tensor  # (NPAY + 1, NK): the features, then depth
    gid_sorted: torch.Tensor  # (NK,) compact ids
    tile_start: torch.Tensor  # (num_tiles,) int32
    tile_stop: torch.Tensor  # (num_tiles,) int32
    num_instances: torch.Tensor  # () int32
    num_large: torch.Tensor  # () int32: gaussians with touched > ksmall


def compact_gaussians(feats: torch.Tensor, aux: dict,
                      config: RasterConfig) -> CompactGaussians:
    """feats: (NPAY, N) payloads; aux: rect_min_x/y, rect_w, touched (int32),
    depth (f32), alive (bool), each (N,). Under capacity pressure the
    faintest gaussians are dropped (graceful overflow)."""
    alive = aux["alive"]
    n = alive.shape[0]
    nc = config.compact
    if n < nc:  # small scenes: pad up to the compaction capacity
        pad = nc - n
        feats = torch.nn.functional.pad(feats, (0, pad))
        aux = {k: torch.nn.functional.pad(v, (0, pad)) for k, v in aux.items()}
        alive = aux["alive"]
    opac = feats[5]
    opac_q = to_int32(65535.0 * (1.0 - torch.clamp(opac, 0.0, 1.0)))
    key = torch.where(alive & torch.isfinite(opac), opac_q, DEAD_KEY)
    key_s, order = torch.sort(key, stable=True)
    key_s, order = key_s[:nc], order[:nc]
    valid = key_s < DEAD_KEY
    return CompactGaussians(
        feats=feats[:, order],
        rect_min_x=aux["rect_min_x"][order],
        rect_min_y=aux["rect_min_y"][order],
        rect_w=aux["rect_w"][order],
        touched=torch.where(valid, aux["touched"][order], 0),
        depth=aux["depth"][order],
        orig_id=order.to(torch.int32),
        valid=valid,
        num_valid=alive.sum(dtype=torch.int32),
    )


def _expand_grid(rmx, rmy, rw_, touched, k_lo, k_hi, tx, num_tiles):
    """Tile of slot k in [k_lo, k_hi) of each gaussian, row-major
    [n, k_hi - k_lo] flattened; slots past `touched` get the sentinel tile."""
    k = torch.arange(k_lo, k_hi, dtype=torch.int32, device=rmx.device)[None]
    ok = k < touched[:, None]
    rw = torch.clamp(rw_, min=1)[:, None]
    dy = k // rw
    dx = k - dy * rw
    tile = (rmy[:, None] + dy) * tx + (rmx[:, None] + dx)
    return torch.where(ok, tile, num_tiles).reshape(-1)


def depth_order_key(depth: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) that orders f32 values as lax.sort does (total
    order, -0 == +0, every NaN equal and last)."""
    x = torch.where(depth == 0.0, 0.0, depth)
    x = torch.where(torch.isnan(x), float("nan"), x)
    bits = x.view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits) + (1 << 31)


def expand_and_sort(cg: CompactGaussians, num_tiles_x: int, num_tiles_y: int,
                    config: RasterConfig) -> BinnedInstances:
    if config.nmid:
        raise ValueError("3-tier (nmid) binning is packed-eval only; the "
                         "training expansion is 2-tier")
    nc, km = config.compact, config.kmax
    tx = num_tiles_x
    num_tiles = num_tiles_x * num_tiles_y
    dev = cg.touched.device

    gid0 = torch.arange(nc, dtype=torch.int32, device=dev)
    touched = torch.clamp(cg.touched, max=km)
    if config.ksmall:
        ks, nl = config.ksmall, config.nlarge
        tile_s = _expand_grid(cg.rect_min_x, cg.rect_min_y, cg.rect_w,
                              touched, 0, ks, tx, num_tiles)
        # the nlarge largest footprints get the remaining slots (stable:
        # ties keep compact order)
        sel_key = torch.where(touched <= ks, km + 1, km - touched)
        gid_l = torch.sort(sel_key, stable=True).indices[:nl]
        touched_l = touched[gid_l]
        tile_l = _expand_grid(cg.rect_min_x[gid_l], cg.rect_min_y[gid_l],
                              cg.rect_w[gid_l], touched_l, ks, km, tx,
                              num_tiles)
        tile = torch.cat([tile_s, tile_l])
        gid = torch.cat([gid0.repeat_interleave(ks),
                         gid_l.to(torch.int32).repeat_interleave(km - ks)])
        num_instances = (torch.clamp(touched, max=ks).sum(dtype=torch.int32)
                         + torch.clamp(touched_l - ks, min=0).sum(
                             dtype=torch.int32))
        num_large = (touched > ks).sum(dtype=torch.int32)
    else:
        tile = _expand_grid(cg.rect_min_x, cg.rect_min_y, cg.rect_w, touched,
                            0, km, tx, num_tiles)
        gid = gid0.repeat_interleave(km)
        num_instances = touched.sum(dtype=torch.int32)
        num_large = torch.zeros((), dtype=torch.int32, device=dev)

    depth = cg.depth[gid]
    key = (tile.to(torch.int64) << 32) | depth_order_key(depth)
    order = torch.sort(key, stable=True).indices
    tile_sorted = tile[order]
    gid_sorted = gid[order]
    feats_sorted = torch.cat(
        [cg.feats[:, gid_sorted], depth[order][None]], dim=0)

    tiles = torch.arange(num_tiles, dtype=tile_sorted.dtype, device=dev)
    tile_start = torch.searchsorted(tile_sorted, tiles, side="left")
    tile_stop = torch.searchsorted(tile_sorted, tiles, side="right")
    return BinnedInstances(
        feats_sorted=feats_sorted,
        gid_sorted=gid_sorted,
        tile_start=tile_start.to(torch.int32),
        tile_stop=tile_stop.to(torch.int32),
        num_instances=num_instances,
        num_large=num_large,
    )
