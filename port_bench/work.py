"""The yardstick of the blend rooflines and the mfu metrics: the card's
peaks, the work of one binned view and of one step, counted from shapes
and from plain per-pair alphas. Frozen copies of `chip_smoke.py`'s `bound`,
`pair_counts`, `blend_work` and `eval_work` and of the plain versions'
per-pair alpha (`ops/rasterizer/blend.py:_group_alpha`) and column decode,
so that a later change to the program cannot move the count.

Instance bytes are counted in the f32 row layout (40 B a training instance,
36 B an eval one) and operations from the pairs tested and taken, so both
stay fixed when a kernel or a layout changes.
"""

from __future__ import annotations

import math

import torch

# NVIDIA H100 SXM data sheet at 700 W: HBM3 rate, FP32 outside the tensor
# cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# FP32 operations per (pixel, instance) pair, a multiply-add as two and
# expf or a division as one: every tested pair costs the offset (2), the
# EWA exponent (9) and the power test (1); a taken pair costs besides 16 in
# the forward (exp, op G, the clamp, the alpha test, T, the latch test, w,
# four weighted sums), 50 in the backward and 14 in the eval forward.
OPS_PER_TEST = 12
FWD_OPS_PER_TAKE = 16
BWD_OPS_PER_TAKE = 50
EVAL_OPS_PER_TAKE = FWD_OPS_PER_TAKE - 2
TRAIN_INSTANCE_BYTES = 40
EVAL_INSTANCE_BYTES = 36
GROUP_ELEMS = 1 << 24
F_X, F_Y, F_CA, F_CB, F_CC, F_OP = range(6)


def bound_s(work: tuple[float, float]) -> float:
    """The least time (s) the card takes to move `work` = (bytes, FP32
    operations): the larger of bytes over the memory rate and operations
    over the FP32 peak."""
    return max(work[0] / HBM_BYTES_PER_S, work[1] / FP32_OPS_PER_S)


def _tile_groups(counts: list[int], npix: int):
    t0, nt = 0, len(counts)
    while t0 < nt:
        t1, longest = t0 + 1, counts[t0]
        while t1 < nt and (t1 - t0 + 1) * npix * max(longest, counts[t1]) \
                <= GROUP_ELEMS:
            longest = max(longest, counts[t1])
            t1 += 1
        if longest > 0:
            yield t0, t1, longest
        t0 = t1


def _f16(bits: torch.Tensor) -> torch.Tensor:
    signed = ((bits & 0xFFFF) ^ 0x8000) - 0x8000
    return signed.to(torch.int16).view(torch.float16).to(torch.float32)


def decode_columns(cols: torch.Tensor, pack8: bool) -> torch.Tensor:
    """The eval kernel's packed columns (int32 bit patterns) as f32 rows x,
    y (tile-local), conic a, b, c, opacity, r, g, b."""
    u = cols.to(torch.int64) & 0xFFFFFFFF
    lo = [_f16(c) for c in u]
    hi = [_f16(c >> 16) for c in u]
    rows = [lo[0], hi[0], lo[1], hi[1], lo[2]]
    if pack8:
        rows += [((u[2] >> 16) & 0x7FF).float() / 2047.0,
                 *(((u[3] >> s) & 0xFF).float() / 255.0 for s in (0, 8, 16))]
    else:
        rows += [hi[2], lo[3], hi[3], lo[4]]
    return torch.stack(rows)


@torch.no_grad()
def pair_counts(feats, tile_start, tile_stop, tiles_x, tile, alpha_min,
                alpha_clamp, t_min, tile_local=False) -> dict:
    """The (pixel, instance) pairs of one binned view: `fwd_tested` (every
    instance up to the one at which the pixel latches), `taken` (the pixel
    composites it), `bwd_tested` (below the pixel's contributor count),
    `walked_fwd` (over tiles, the most one pixel tests) and `walked_bwd`
    (over tiles, the largest contributor count)."""
    dev = feats.device
    npix = tile * tile
    counts = (tile_stop - tile_start).tolist()
    n = dict.fromkeys(("fwd_tested", "bwd_tested", "taken", "walked_fwd",
                       "walked_bwd"), 0)
    p = torch.arange(npix, device=dev)
    for t0, t1, length in _tile_groups(counts, npix):
        j = torch.arange(length, device=dev)
        inside = j[None] < torch.tensor(counts[t0:t1], device=dev)[:, None]
        idx = torch.where(inside, tile_start[t0:t1, None].long() + j[None], 0)
        f = feats[:, idx]
        t = torch.arange(t0, t1, device=dev)
        if tile_local:
            t = torch.zeros_like(t)
        px = ((t % tiles_x) * tile).float()[:, None] + (p % tile).float()[None]
        py = ((t // tiles_x) * tile).float()[:, None] + (p // tile).float()[None]
        dx = f[F_X][:, None, :] - px[:, :, None]
        dy = f[F_Y][:, None, :] - py[:, :, None]
        power = (-0.5 * (f[F_CA][:, None, :] * dx * dx
                         + f[F_CC][:, None, :] * dy * dy)
                 - f[F_CB][:, None, :] * dx * dy)
        alpha = torch.clamp(f[F_OP][:, None, :] * torch.exp(power),
                            max=alpha_clamp)
        ok = inside[:, None, :] & (power <= 0.0) & (alpha >= alpha_min)
        alpha = torch.where(ok, alpha, 0.0)
        cum = torch.cumprod(1.0 - alpha, -1)
        before = torch.cat([torch.ones_like(cum[..., :1]), cum[..., :-1]], -1)
        accept = cum >= t_min
        taken = accept & (alpha > 0.0)
        rank = torch.arange(1, length + 1, device=dev)
        ncontrib = torch.where(taken, rank, 0).amax(-1)  # [B, P]
        tested = (inside[:, None, :] & (before >= t_min)).sum(-1)
        n["fwd_tested"] += int(tested.sum())
        n["walked_fwd"] += int(tested.amax(-1).sum())
        n["bwd_tested"] += int(ncontrib.sum())
        n["walked_bwd"] += int(ncontrib.amax(-1).sum())
        n["taken"] += int(taken.sum())
    return n


def train_blend_work(tile_start, nk, npix, pairs, n_instances):
    """(bytes, operations) of the training forward and backward on one
    binned view: the forward reads each instance of the tile ranges once,
    the ranges and bg, and writes 24 B a pixel; the backward reads the
    instances up to each tile's largest contributor count, 28 B of
    cotangents and forward outputs a pixel, and writes the [10, NK]
    gradient rows once."""
    nt = tile_start.shape[0]
    fwd = (n_instances * TRAIN_INSTANCE_BYTES + nt * 8 + 12 + nt * npix * 24,
           OPS_PER_TEST * pairs["fwd_tested"]
           + FWD_OPS_PER_TAKE * pairs["taken"])
    bwd = (pairs["walked_bwd"] * TRAIN_INSTANCE_BYTES + nt * npix * 28
           + nt * 8 + 12 + TRAIN_INSTANCE_BYTES * nk,
           OPS_PER_TEST * pairs["bwd_tested"]
           + BWD_OPS_PER_TAKE * pairs["taken"])
    return fwd, bwd


def eval_blend_work(tile_start, npix, pairs, n_instances):
    """(bytes, operations) of the eval forward on one binned view: each
    instance read once in the f32 row layout, the ranges and bg, 12 B of
    colour written a pixel."""
    nt = tile_start.shape[0]
    return (n_instances * EVAL_INSTANCE_BYTES + nt * 8 + 12 + nt * npix * 12,
            OPS_PER_TEST * pairs["fwd_tested"]
            + EVAL_OPS_PER_TAKE * pairs["taken"])


def decoder_ops(mc: dict, visible_anchors: int) -> float:
    """Forward FP32 operations of the three decoder MLPs and the appearance
    code on the anchors the prefilter kept (a multiply-add as two)."""
    f, k, a = mc["feat_dim"], mc["n_offsets"], mc["appearance_dim"]
    d_in = f + 3
    per_anchor = 2 * (d_in * f + f * k) + 2 * (d_in * f + f * 7 * k) \
        + 2 * ((d_in + a) * f + f * 3 * k)
    return float(per_anchor * visible_anchors + 2 * 7 * a)


def loss_ops(width: int, height: int, scales: int) -> float:
    """Forward FP32 operations of the loss on one image: L1 (3 a value), the
    SSIM (five maps blurred by two 11-tap passes, 2 operations a tap, and
    25 a pixel for the formula) and the high-frequency terms (two images'
    2-D FFTs at 5 N log2 N, the amplitudes and their difference, 8 a
    value, at each scale)."""
    n = 3 * width * height
    ops = 3 * n + n * (5 * 2 * 11 * 2) + 25 * width * height
    for i in range(scales):
        m = n / 4**i
        ops += 2 * 5 * m * math.log2(max(m / 3, 2)) + 8 * m
    return float(ops)
