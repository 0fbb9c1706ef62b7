"""Tile binning: priority compaction, kmax / dual-rate expansion, and one
stable (tile, depth) sort; and the packed eval binning.

Port of segs_slam_tpu/ops/rasterizer/binning.py (reference:
cuda_rasterizer/rasterizer_impl.cu:70-138, 276-308). The JAX version
carries every feature through its sorts as
payload because gathers are slow on the TPU; here the sorts carry only
indices and the features are gathered afterwards, which gives the same
arrays. The f32 (training) binning:

  1. compact: stable sort of a 16-bit opacity-priority key (dead rows last),
     keep the leading `compact` gaussians;
  2. expand each compact gaussian to its tile slots, in the JAX expansion
     order (the small tier [compact, ksmall] row-major, then the nlarge
     largest footprints' remaining slots);
  3. one stable sort on an int64 key (tile << 32 | order-preserving depth
     bits), i.e. lax.sort's (tile, depth) order with ties in expansion order;
  4. tile ranges by searchsorted.

The exact binning (`bin_exact`, RasterConfig.exact) keeps every alive
gaussian and every tile of its rect, with neither step 1's cap nor the
kmax clamp. The packed binnings, the eval one and the training one
(`expand_and_sort_packed_train`), are described with their layouts below.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from segs_slam_tpu_torch.ops.rasterizer.preprocess import (
    DEPTH_KEY_BITS,
    MAX_COMPACT_PACKED_TRAIN,
    MAX_KMAX_PACKED,
    MAX_PACKED_TILES,
    MAX_TILES_X,
    MAX_TILES_Y_PACK8,
    PACKED_TILE,
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


def bin_exact(feats: torch.Tensor, aux: dict, num_tiles_x: int,
              num_tiles_y: int) -> tuple[BinnedInstances, torch.Tensor]:
    """The published rasterizer's binning (RasterConfig.exact; reference:
    rasterizer_impl.cu duplicateWithKeys + identifyTileRanges): every alive
    gaussian with a finite opacity, one (tile, depth) key for every tile of
    its whole rect. Count, exclusive scan, emit, one stable sort, tile
    ranges: as many pairs as the view has, ties in (gaussian, tile) order.
    The pair count is read on the host once, to size the emit.

    feats and aux as `compact_gaussians`. Returns (BinnedInstances with
    gid_sorted the rows' own indices into [N] and num_large 0, num_valid:
    the gaussians binned)."""
    num_tiles = num_tiles_x * num_tiles_y
    dev = feats.device
    alive = aux["alive"] & torch.isfinite(feats[5])
    touched = torch.where(alive, aux["touched"], 0).to(torch.int64)
    rows = torch.nonzero(touched).squeeze(1)
    counts = touched[rows]
    num_instances = counts.sum(dtype=torch.int32)
    total = int(num_instances)
    ends = torch.cumsum(counts, 0)
    # each pair's gaussian and its slot k in the gaussian's rect, row-major
    gid = torch.repeat_interleave(rows, counts, output_size=total)
    k = torch.arange(total, device=dev) - torch.repeat_interleave(
        ends - counts, counts, output_size=total)
    rw = torch.clamp(aux["rect_w"], min=1).to(torch.int64)[gid]
    dy = torch.div(k, rw, rounding_mode="floor")
    tile = ((aux["rect_min_y"].to(torch.int64)[gid] + dy) * num_tiles_x
            + aux["rect_min_x"].to(torch.int64)[gid] + (k - dy * rw))
    depth = aux["depth"][gid]
    key = (tile << 32) | depth_order_key(depth)
    key_sorted, order = torch.sort(key, stable=True)
    gid_sorted = gid[order]
    feats_sorted = torch.cat([feats[:, gid_sorted], depth[order][None]])
    tiles = torch.arange(num_tiles, dtype=torch.int64, device=dev)
    tile_sorted = key_sorted >> 32
    binned = BinnedInstances(
        feats_sorted=feats_sorted,
        gid_sorted=gid_sorted.to(torch.int32),
        tile_start=torch.searchsorted(tile_sorted, tiles,
                                      side="left").to(torch.int32),
        tile_stop=torch.searchsorted(tile_sorted, tiles,
                                     side="right").to(torch.int32),
        num_instances=num_instances,
        num_large=torch.zeros((), dtype=torch.int32, device=dev),
    )
    return binned, alive.sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# Packed eval binning (segs_slam_tpu/ops/rasterizer/binning.py:237-724). The
# JAX package packs feature pairs into f16 halves of u32 columns and fuses
# (tile, depth) into one u32 sort key, to halve the sorted bytes on the TPU;
# the eval blend (kernel K3) decodes the columns itself. The port keeps the
# layouts bit for bit, so that K3 reads what the JAX kernel reads: u32 values
# are held in int64 tensors (torch has few uint32 ops) and handed to the
# kernel as int32 bit patterns.
#
# Columns per gaussian (f16(v) is v's half-precision bit pattern):
#   p_xy   = f16(x - rect_min_x*16) | f16(y - rect_min_y*16) << 16
#   p_cab  = f16(conic.a) | f16(conic.b) << 16
#   p_cco  = f16(conic.c) | f16(opacity) << 16
#   p_rg   = f16(r) | f16(g) << 16
#   p_b    = f16(b) | rect_min_x << 16 | rect_min_y << 24
#   dmeta  = depth_key (21 bits) | min(touched, kmax) << 21 | rect_w << 26
# and under pack8 four payload columns:
#   p_xy, p_cab as above,
#   c2 = f16(conic.c) | round(2047 opacity) << 16 | min(rect_min_y, 31) << 27
#   c3 = round(255 r) | round(255 g) << 8 | round(255 b) << 16
#        | rect_min_x << 24
# Expansion re-bases p_xy from the rect's corner to each instance's own tile,
# so K3's mean2d is tile-local. The limits these layouts set on a config
# are defined beside RasterConfig, whose route methods read them.
# ---------------------------------------------------------------------------

_DKEY_MASK = (1 << DEPTH_KEY_BITS) - 1
_SEL_DEAD = 0xFFFFFFFF  # sel_direct key of a dead row: after every other


def _f16_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 -> its f16 bit pattern (round to nearest even) in int64."""
    return x.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF


def _f16_from_bits(h: torch.Tensor) -> torch.Tensor:
    """int64 f16 bit patterns (low 16 bits) -> f32, exactly."""
    signed = ((h & 0xFFFF) ^ 0x8000) - 0x8000
    return signed.to(torch.int16).view(torch.float16).to(torch.float32)


def _pack2f16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two f32 tensors -> one u32 value (a's f16 low, b's high), in int64."""
    return _f16_bits(a) | (_f16_bits(b) << 16)


def _unpack2f16(p: torch.Tensor):
    return _f16_from_bits(p), _f16_from_bits(p >> 16)


def _depth_key(depth: torch.Tensor) -> torch.Tensor:
    """Monotonic 21-bit key of positive f32 depths: the top 21 bits of the
    f32 pattern."""
    bits = depth.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return bits >> (32 - DEPTH_KEY_BITS)


def _to_uint(x: torch.Tensor) -> torch.Tensor:
    """Non-negative f32 -> int64 by truncation, NaN -> 0 (XLA's f32 -> u32
    on the values the packers give it)."""
    return torch.nan_to_num(x, nan=0.0).to(torch.int64)


def as_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 with the same 32-bit patterns."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


class PackedCompact(NamedTuple):
    cols: torch.Tensor  # (5, compact) int64: p_xy, p_cab, p_cco, p_rg, p_b
    dmeta: torch.Tensor  # (compact,) int64; touched 0 for dead slots
    valid: torch.Tensor  # (compact,) bool
    num_valid: torch.Tensor  # () int32
    # (compact,) int32 index into the (padded) [N] rows: training only
    orig_id: torch.Tensor | None = None


def _pack_eval_cols(feats: torch.Tensor, aux: dict, config: RasterConfig):
    """Packed columns of the raw [N] rows: (payload cols [5 or 4, N],
    dmeta [N], alive_ok, opac_q, num_valid). Dead rows carry touched 0 in
    dmeta, so they expand to no tile wherever they land."""
    if config.kmax > MAX_KMAX_PACKED:
        raise ValueError("touched packs into dmeta bits 21..25: kmax <= 31")
    alive = aux["alive"]
    x, y, ca, cb, cc, op, r, g, b = feats
    opac_q = _to_uint(65535.0 * (1.0 - torch.clamp(op, 0.0, 1.0)))
    alive_ok = alive & torch.isfinite(op)
    rmx = torch.clamp(aux["rect_min_x"], 0, 255).to(torch.int64)
    rmy = torch.clamp(aux["rect_min_y"], 0, 255).to(torch.int64)
    rw = torch.clamp(aux["rect_w"], 0, 63).to(torch.int64)
    touched = torch.where(alive_ok, torch.clamp(aux["touched"], 0, config.kmax),
                          0).to(torch.int64)
    # a dead slot's depth may be anything: a positive one keeps the key sane
    depth_safe = torch.where(alive_ok, aux["depth"], 1.0)
    dmeta = (_depth_key(depth_safe) | (touched << DEPTH_KEY_BITS)
             | (rw << (DEPTH_KEY_BITS + 5)))
    p_xy = _pack2f16(x - rmx.to(torch.float32) * 16.0,
                     y - rmy.to(torch.float32) * 16.0)
    if config.pack8:
        def q(v, levels):
            return _to_uint(torch.clamp(
                torch.round(torch.clamp(v, 0.0, 1.0) * levels), 0, levels))

        pays = (
            p_xy,
            _pack2f16(ca, cb),
            _f16_bits(cc) | (q(op, 2047) << 16)
            | (torch.clamp(rmy, max=31) << 27),
            q(r, 255) | (q(g, 255) << 8) | (q(b, 255) << 16) | (rmx << 24),
        )
    else:
        pays = (
            p_xy,
            _pack2f16(ca, cb),
            _pack2f16(cc, op),
            _pack2f16(r, g),
            _f16_bits(b) | (rmx << 16) | (rmy << 24),
        )
    num_valid = alive_ok.sum(dtype=torch.int32)
    return torch.stack(pays), dmeta, alive_ok, opac_q, num_valid


def _pad_rows(feats, aux, nc):
    """Pad the raw rows up to the compaction capacity (dead, zero rows)."""
    pad = nc - feats.shape[1]
    if pad <= 0:
        return feats, aux
    return (torch.nn.functional.pad(feats, (0, pad)),
            {k: torch.nn.functional.pad(v, (0, pad)) for k, v in aux.items()})


def _kanchor_rows(key: torch.Tensor, config: RasterConfig) -> torch.Tensor:
    """The per-anchor K-axis pre-compaction (RasterConfig.kanchor): each
    group of kgroup consecutive rows (one anchor's offsets) stably sorted by
    `key`, and the kanchor first of each kept. Returns the kept rows'
    indices, anchor-major. JAX's odd-even transposition network (kgroup
    passes, a swap only on a strict >) is a complete stable sort, so one
    stable sort along the group axis keeps the same rows in the same
    order."""
    ka, kg = config.kanchor, config.kgroup
    order = torch.sort(key.reshape(-1, kg), dim=1, stable=True).indices
    base = torch.arange(0, key.shape[0], kg, device=key.device)[:, None]
    return (base + order[:, :ka]).reshape(-1)


def _pad_cols(key, pays, dmeta, nc, dead_key):
    """Pad the key, payload and dmeta columns up to the compaction capacity
    with dead, zero rows."""
    pad = nc - key.shape[0]
    if pad <= 0:
        return key, pays, dmeta
    f = torch.nn.functional.pad
    return (f(key, (0, pad), value=dead_key), f(pays, (0, pad)),
            f(dmeta, (0, pad)))


def compact_gaussians_packed(feats: torch.Tensor, aux: dict,
                             config: RasterConfig,
                             with_orig: bool = False) -> PackedCompact:
    """Opacity-priority compaction of the packed columns (the key of
    `compact_gaussians`): the leading `compact` rows of one stable sort.
    with_orig adds the rows' original indices, which the training backward
    scatters through. Without it, and where the rows split into whole
    anchors, config.kanchor first keeps each anchor's kanchor most opaque
    rows (`_kanchor_rows`), as the JAX version does."""
    nc = config.compact
    feats, aux = _pad_rows(feats, aux, nc)
    pays, dmeta, alive_ok, opac_q, num_valid = _pack_eval_cols(feats, aux,
                                                               config)
    key = torch.where(alive_ok, opac_q, DEAD_KEY)
    if config.kanchor and not with_orig \
            and key.shape[0] % config.kgroup == 0:
        rows = _kanchor_rows(key, config)
        key, pays, dmeta = _pad_cols(key[rows], pays[:, rows], dmeta[rows],
                                     nc, DEAD_KEY)
    key_s, order = torch.sort(key, stable=True)
    order = order[:nc]
    valid = key_s[:nc] < DEAD_KEY
    return PackedCompact(cols=pays[:, order],
                         dmeta=torch.where(valid, dmeta[order], 0),
                         valid=valid, num_valid=num_valid,
                         orig_id=order.to(torch.int32) if with_orig else None)


def _touched(dmeta):
    return (dmeta >> DEPTH_KEY_BITS) & 0x1F


def _expand_tier(cols, dmeta, rows, k_lo, k_hi, tx, num_tiles):
    """Instances of slots k in [k_lo, k_hi) of the source rows `rows`
    (indices into cols / dmeta), row-major [len(rows), k_hi - k_lo]
    flattened: (ukey = tile << 21 | depth key, source row, dx, dy), with
    (dx, dy) the instance's tile offset from its rect's corner. The rect
    corner is read from the columns as the JAX expansion reads it (p_b, or
    pack8's c2 / c3)."""
    c = cols[:, rows]
    dm = dmeta[rows]
    if cols.shape[0] == 4:  # pack8
        rmx, rmy = c[3] >> 24, (c[2] >> 27) & 0x1F
    else:
        rmx, rmy = (c[4] >> 16) & 0xFF, (c[4] >> 24) & 0xFF
    rw = torch.clamp((dm >> (DEPTH_KEY_BITS + 5)) & 0x3F, min=1)[:, None]
    k = torch.arange(k_lo, k_hi, dtype=torch.int64, device=dm.device)[None]
    ok = k < _touched(dm)[:, None]
    dy = k // rw
    dx = k - dy * rw
    tile = torch.where(ok, (rmy[:, None] + dy) * tx + rmx[:, None] + dx,
                       num_tiles)
    ukey = (tile << DEPTH_KEY_BITS) | (dm & _DKEY_MASK)[:, None]
    kw = k_hi - k_lo
    return (ukey.reshape(-1), rows[:, None].expand(-1, kw).reshape(-1),
            dx.reshape(-1), dy.reshape(-1))


def _expand_tiers(cols, dmeta, base_rows, sel_rows, tx, num_tiles,
                  config: RasterConfig):
    """The tiered expansion shared by both packed binnings: every base row
    gets slots [0, ksmall); the leading nmid / nlarge rows of `sel_rows`
    (largest footprints first) get [ksmall, kmid) / [kmid, kmax), or, with
    two tiers, the nlarge leading ones [ksmall, kmax). Returns the
    concatenated instances and num_instances."""
    ks, km = config.ksmall, config.kmax
    tiers = [(base_rows, 0, ks)]
    if config.nmid:
        tiers += [(sel_rows[:config.nmid], ks, config.kmid),
                  (sel_rows[:config.nlarge], config.kmid, km)]
    else:
        tiers += [(sel_rows[:config.nlarge], ks, km)]
    parts = [_expand_tier(cols, dmeta, rows, lo, hi, tx, num_tiles)
             for rows, lo, hi in tiers]
    # slots actually emitted: each tier's share of every row's footprint
    num_instances = sum(
        torch.clamp(_touched(dmeta[rows]) - lo, 0, hi - lo).sum(
            dtype=torch.int32) for rows, lo, hi in tiers)
    return tuple(torch.cat(p) for p in zip(*parts)), num_instances


def _check_packed_grid(num_tiles_x, num_tiles_y, config: RasterConfig):
    if config.tile != PACKED_TILE:
        raise ValueError("the packed binning assumes 16 px tiles")
    if num_tiles_x * num_tiles_y > MAX_PACKED_TILES:
        raise ValueError("the tile id must fit above the 21-bit depth key")
    if num_tiles_x > MAX_TILES_X:
        raise ValueError("rect_w packs into 6 bits: at most 63 tile columns")


def expand_and_sort_packed(pc: PackedCompact, num_tiles_x: int,
                           num_tiles_y: int, config: RasterConfig,
                           return_packed: bool = False):
    """Packed instance sort over the compacted rows, with 1, 2 or 3 tiers.
    Returns (feats_sorted [10, NK] f32 (x, y, conic, opacity, rgb, zero
    depth; absolute mean2d) or, with return_packed, the sorted u32 columns
    [5, NK] in int64 with tile-local p_xy; tile_start, tile_stop,
    num_instances, num_large)."""
    _check_packed_grid(num_tiles_x, num_tiles_y, config)
    nc, km, ks = config.compact, config.kmax, config.ksmall
    num_tiles = num_tiles_x * num_tiles_y
    dev = pc.dmeta.device
    base = torch.arange(nc, device=dev)
    touched = _touched(pc.dmeta)
    if ks:
        # the largest footprints first (stable: ties keep compact order)
        sel_key = torch.where(touched <= ks, km + 1, km - touched)
        sel = torch.sort(sel_key, stable=True).indices
        inst, num_instances = _expand_tiers(pc.cols, pc.dmeta, base, sel,
                                            num_tiles_x, num_tiles, config)
        num_large = (touched > ks).sum(dtype=torch.int32)
    else:
        inst = _expand_tier(pc.cols, pc.dmeta, base, 0, km, num_tiles_x,
                            num_tiles)
        num_instances = touched.sum(dtype=torch.int32)
        num_large = torch.zeros((), dtype=torch.int32, device=dev)
    return _finalize_eval_instances(pc.cols, inst, num_tiles, num_tiles_x,
                                    num_instances, num_large, return_packed)


def _sort_instances(cols, inst, num_tiles):
    """The (tile, depth) instance sort shared by the packed binnings:
    (sorted ukeys, the sorted instances' columns with p_xy re-based to each
    instance's tile, tile_start, tile_stop)."""
    ukey, rows, dx, dy = inst
    ukey_sorted, order = torch.sort(ukey, stable=True)
    rows, dx, dy = rows[order], dx[order], dy[order]
    cols_s = cols[:, rows]
    xr, yr = _unpack2f16(cols_s[0])
    # the offset (dx, dy) * 16 is exact in f32: one more f16 rounding
    cols_s[0] = _pack2f16(xr - dx.to(torch.float32) * 16.0,
                          yr - dy.to(torch.float32) * 16.0)
    tile_sorted = ukey_sorted >> DEPTH_KEY_BITS
    tiles = torch.arange(num_tiles, dtype=torch.int64, device=ukey.device)
    tile_start = torch.searchsorted(tile_sorted, tiles, side="left").to(
        torch.int32)
    tile_stop = torch.searchsorted(tile_sorted, tiles, side="right").to(
        torch.int32)
    return ukey_sorted, cols_s, tile_start, tile_stop


def _finalize_eval_instances(cols, inst, num_tiles, tx, num_instances,
                             extra, return_packed):
    """The instance sort, the gather of the sorted columns with p_xy
    re-based to each instance's tile, and the tile ranges; optionally the
    unpack to f32 feature rows."""
    ukey_sorted, cols_s, tile_start, tile_stop = _sort_instances(
        cols, inst, num_tiles)
    tile_sorted = ukey_sorted >> DEPTH_KEY_BITS
    if return_packed:
        return cols_s, tile_start, tile_stop, num_instances, extra

    # f32 feature rows; absolute mean2d from the instance's tile id. The
    # depth row is zero: the eval path discards the depth image
    xr, yr = _unpack2f16(cols_s[0])
    tile_c = torch.clamp(tile_sorted, max=num_tiles - 1)
    ty_i = tile_c // tx
    tx_i = tile_c - ty_i * tx
    ca, cb = _unpack2f16(cols_s[1])
    cc, op = _unpack2f16(cols_s[2])
    r, g = _unpack2f16(cols_s[3])
    b = _f16_from_bits(cols_s[4])
    feats_sorted = torch.stack([
        xr + tx_i.to(torch.float32) * 16.0, yr + ty_i.to(torch.float32) * 16.0,
        ca, cb, cc, op, r, g, b, torch.zeros_like(xr)])
    return feats_sorted, tile_start, tile_stop, num_instances, extra


def bin_eval_direct(feats: torch.Tensor, aux: dict, num_tiles_x: int,
                    num_tiles_y: int, config: RasterConfig,
                    return_packed: bool = False):
    """Direct-selection packed eval binning (RasterConfig.sel_direct): one
    stable sort of the raw rows by footprint (descending), then opacity
    (descending), dead rows last, is both the compaction (its leading
    `compact` rows get ksmall slots) and the tier selection (its nmid /
    nlarge prefixes). Under capacity pressure the smallest, then faintest,
    gaussians drop. With config.kanchor (and whole anchors), each anchor's
    kanchor first rows by that key go into the sort (`_kanchor_rows`).
    Returns (cols or feats, tile_start, tile_stop, num_instances,
    num_valid) as expand_and_sort_packed."""
    _check_packed_grid(num_tiles_x, num_tiles_y, config)
    if not config.ksmall:
        raise ValueError("sel_direct requires the tiered expansion")
    if config.pack8:
        if num_tiles_y > MAX_TILES_Y_PACK8:
            raise ValueError("pack8 packs rect_min_y into 5 bits: at most "
                             "31 tile rows")
        if not return_packed:
            raise ValueError("pack8 columns are decoded by the kernel only")
    nc, km = config.compact, config.kmax
    pays, dmeta, alive_ok, opac_q, num_valid = _pack_eval_cols(feats, aux,
                                                               config)
    sel_key = torch.where(alive_ok, ((km - _touched(dmeta)) << 16) | opac_q,
                          _SEL_DEAD)
    if config.kanchor and sel_key.shape[0] % config.kgroup == 0:
        # each anchor's kanchor first rows by the footprint-primary key
        rows = _kanchor_rows(sel_key, config)
        sel_key, pays, dmeta = sel_key[rows], pays[:, rows], dmeta[rows]
    sel_key, pays, dmeta = _pad_cols(sel_key, pays, dmeta, nc, _SEL_DEAD)
    sel = torch.sort(sel_key, stable=True).indices
    inst, num_instances = _expand_tiers(pays, dmeta, sel[:nc], sel,
                                        num_tiles_x,
                                        num_tiles_x * num_tiles_y, config)
    return _finalize_eval_instances(pays, inst, num_tiles_x * num_tiles_y,
                                    num_tiles_x, num_instances, num_valid,
                                    return_packed)


def expand_and_sort_packed_train(pc: PackedCompact, num_tiles_x: int,
                                 num_tiles_y: int,
                                 config: RasterConfig) -> BinnedInstances:
    """The packed instance sort of the training path
    (RasterConfig.packed_train): the eval packing plus the routing the
    backward needs. The compact id rides in the top 16 bits of the b
    column (so compact <= 2^16), and each instance's depth is the f32
    rebuilt from its 21-bit depth key (the top 21 bits of the pattern).
    Returns the f32 binning's BinnedInstances: feats_sorted [10, NK] with
    absolute mean2d, gid_sorted, tile ranges, num_instances, num_large.
    `pc` comes from compact_gaussians_packed(..., with_orig=True)."""
    if config.nmid:
        raise ValueError("3-tier (nmid) binning is packed-eval only; the "
                         "training expansion is 2-tier")
    _check_packed_grid(num_tiles_x, num_tiles_y, config)
    nc, km, ks = config.compact, config.kmax, config.ksmall
    if nc > MAX_COMPACT_PACKED_TRAIN:
        raise ValueError("packed_train packs the compact id into 16 bits: "
                         "compact <= 2^16")
    num_tiles = num_tiles_x * num_tiles_y
    dev = pc.dmeta.device
    base = torch.arange(nc, device=dev)
    # p_b with its rect corner bits replaced by the compact id; the
    # expansion still reads the corner from p_b (column 4)
    p_bg = (pc.cols[4] & 0xFFFF) | (base << 16)
    cols = torch.cat([pc.cols, p_bg[None]])
    touched = _touched(pc.dmeta)
    if ks:
        sel_key = torch.where(touched <= ks, km + 1, km - touched)
        sel = torch.sort(sel_key, stable=True).indices
        inst, num_instances = _expand_tiers(cols, pc.dmeta, base, sel,
                                            num_tiles_x, num_tiles, config)
        num_large = (touched > ks).sum(dtype=torch.int32)
    else:
        inst = _expand_tier(cols, pc.dmeta, base, 0, km, num_tiles_x,
                            num_tiles)
        num_instances = touched.sum(dtype=torch.int32)
        num_large = torch.zeros((), dtype=torch.int32, device=dev)

    ukey_sorted, cols_s, tile_start, tile_stop = _sort_instances(
        cols, inst, num_tiles)
    tile_sorted = ukey_sorted >> DEPTH_KEY_BITS
    xr, yr = _unpack2f16(cols_s[0])
    tile_c = torch.clamp(tile_sorted, max=num_tiles - 1)
    ty_i = tile_c // num_tiles_x
    tx_i = tile_c - ty_i * num_tiles_x
    ca, cb = _unpack2f16(cols_s[1])
    cc, op = _unpack2f16(cols_s[2])
    r, g = _unpack2f16(cols_s[3])
    b = _f16_from_bits(cols_s[5])
    depth = as_u32_bits((ukey_sorted & _DKEY_MASK)
                        << (32 - DEPTH_KEY_BITS)).view(torch.float32)
    feats_sorted = torch.stack([
        xr + tx_i.to(torch.float32) * 16.0, yr + ty_i.to(torch.float32) * 16.0,
        ca, cb, cc, op, r, g, b, depth])
    return BinnedInstances(
        feats_sorted=feats_sorted,
        gid_sorted=(cols_s[5] >> 16).to(torch.int32),
        tile_start=tile_start,
        tile_stop=tile_stop,
        num_instances=num_instances,
        num_large=num_large,
    )
