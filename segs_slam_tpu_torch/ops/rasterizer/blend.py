"""Tile blend: kernels K1 (forward), K2 (backward), K3 and K4 (colour-only
eval forwards), their plain PyTorch versions, the autograd.Function around
the training pipeline and the eval pipeline `binned_blend_eval`.

Port of segs_slam_tpu/ops/rasterizer/blend.py (`binned_blend`, a custom VJP
over compaction + sort (f32 or packed) + the Pallas kernels `_fwd_kernel` /
`_bwd_kernel`;
`binned_blend_eval` over the packed binning and `_fwd_kernel_eval_packed` /
`_fwd_kernel_eval`). The kernels are hand-written CUDA for Hopper in
`csrc/blend_fwd.cu`, `csrc/blend_bwd.cu` and `csrc/blend_eval.cu`;
`blend_forward_reference`, `blend_backward_reference`,
`blend_forward_eval_packed_reference` and `blend_forward_eval_reference`
compute the same functions in plain torch. The dispatchers (`blend_forward`,
`blend_backward`, `blend_forward_eval_packed`, `blend_forward_eval`) launch
the kernels for CUDA tensors and take the plain versions only for tensors on
the CPU.

Sorted feature rows (the [10, NK] array), and the rows of K2's per-instance
gradient array:
  0: mean2d.x  1: mean2d.y  2: conic.a  3: conic.b  4: conic.c
  5: opacity   6: r  7: g  8: b  9: depth
K3 reads the packed u32 columns of the eval binning instead (binning.py),
as int32 bit patterns, with mean2d relative to the instance's tile.
"""

from __future__ import annotations

import ctypes

import torch

from segs_slam_tpu_torch.ops.cuda_lib import launch
from segs_slam_tpu_torch.ops.rasterizer.binning import (
    NPAY,
    _f16_from_bits,
    as_u32_bits,
    bin_eval_direct,
    bin_exact,
    compact_gaussians,
    compact_gaussians_packed,
    expand_and_sort,
    expand_and_sort_packed,
    expand_and_sort_packed_train,
)
from segs_slam_tpu_torch.ops.rasterizer.preprocess import RasterConfig
from segs_slam_tpu_torch.utils import tracing

NFEAT = NPAY + 1
F_X, F_Y, F_CA, F_CB, F_CC, F_OP, F_R, F_G, F_B, F_D = range(NFEAT)

# Plain versions: tiles are processed in groups of at most this many
# (tile, pixel, instance) elements per temporary.
_REF_GROUP_ELEMS = 1 << 24


def _tile_groups(counts: list[int], npix: int):
    """Consecutive tile groups [t0, t1) whose padded [t1 - t0, npix, longest]
    temporaries stay within _REF_GROUP_ELEMS; yields (t0, t1, longest) for
    the groups that hold any instance."""
    nt = len(counts)
    t0 = 0
    while t0 < nt:
        t1, longest = t0 + 1, counts[t0]
        while t1 < nt and (t1 - t0 + 1) * npix * max(longest, counts[t1]) \
                <= _REF_GROUP_ELEMS:
            longest = max(longest, counts[t1])
            t1 += 1
        if longest > 0:
            yield t0, t1, longest
        t0 = t1


def _group_alpha(feats, tile_start, counts, t0, t1, length, tiles_x,
                 config: RasterConfig, tile_local: bool = False):
    """Per-(tile, pixel, instance) quantities of tiles [t0, t1), padded to
    `length` instances: (idx [B, L] columns into feats, inside [B, L],
    f [rows, B, L], dx, dy [B, P, L] = mean2d - pixel, opg = op * G
    unclamped and alpha, both zero where the forward skips the instance).
    With tile_local, mean2d is relative to its tile's corner (K3's input),
    and so are the pixels."""
    dev = feats.device
    b = config.tile
    p = torch.arange(b * b, device=dev)
    j = torch.arange(length, device=dev)
    inside = j[None, :] < torch.tensor(counts[t0:t1], device=dev)[:, None]
    idx = torch.where(inside, tile_start[t0:t1, None].long() + j[None, :], 0)
    f = feats[:, idx]  # [10, B, L]

    t = torch.arange(t0, t1, device=dev)
    if tile_local:
        t = torch.zeros_like(t)
    pix_x = ((t % tiles_x) * b).float()[:, None] + (p % b).float()[None, :]
    pix_y = ((t // tiles_x) * b).float()[:, None] + (p // b).float()[None, :]
    dx = f[F_X][:, None, :] - pix_x[:, :, None]  # [B, P, L]
    dy = f[F_Y][:, None, :] - pix_y[:, :, None]
    power = (-0.5 * (f[F_CA][:, None, :] * dx * dx
                     + f[F_CC][:, None, :] * dy * dy)
             - f[F_CB][:, None, :] * dx * dy)
    opg = f[F_OP][:, None, :] * torch.exp(power)
    alpha = torch.clamp(opg, max=config.alpha_clamp)
    ok = inside[:, None, :] & (power <= 0.0) & (alpha >= config.alpha_min)
    return (idx, inside, f, dx, dy, torch.where(ok, opg, 0.0),
            torch.where(ok, alpha, 0.0))


def _forward_reference(feats, tile_start, tile_stop, bg, tiles_x,
                       config: RasterConfig, tile_local: bool = False,
                       with_depth: bool = True):
    """The plain version of the forward kernels: per tile, alpha for every
    (pixel, instance), then T = cumprod(1 - alpha), accept = T >=
    transmittance_min (a prefix, which is the reference's latch), weights
    alpha * T_before. Returns (color, final_T, depth (zeros without
    with_depth), n_contrib)."""
    dev = feats.device
    nt = tile_start.shape[0]
    npix = config.tile * config.tile
    color = bg.reshape(1, 3, 1).expand(nt, 3, npix).clone()
    final_t = torch.ones((nt, 1, npix), dtype=torch.float32, device=dev)
    depth = torch.zeros((nt, 1, npix), dtype=torch.float32, device=dev)
    ncontrib = torch.zeros((nt, 1, npix), dtype=torch.int32, device=dev)

    counts = (tile_stop - tile_start).tolist()
    for t0, t1, length in _tile_groups(counts, npix):
        _, _, f, _, _, _, alpha = _group_alpha(
            feats, tile_start, counts, t0, t1, length, tiles_x, config,
            tile_local)
        cum = torch.cumprod(1.0 - alpha, dim=-1)  # T after each instance
        t_before = torch.cat([torch.ones_like(cum[..., :1]), cum[..., :-1]],
                             -1)
        accept = cum >= config.transmittance_min
        w = torch.where(accept, alpha * t_before, 0.0)  # [B, P, L]
        T = torch.where(accept, cum, 1.0).amin(dim=-1)  # [B, P]
        rgb = f[F_R:F_B + 1]  # [3, B, L]
        color[t0:t1] = (torch.einsum("bpl,cbl->bcp", w, rgb)
                        + bg.reshape(1, 3, 1) * T[:, None, :])
        final_t[t0:t1] = T[:, None, :]
        if with_depth:
            depth[t0:t1] = torch.einsum("bpl,bl->bp", w, f[F_D])[:, None, :]
        rank = torch.arange(1, length + 1, dtype=torch.int32, device=dev)
        ncontrib[t0:t1] = torch.where(accept & (alpha > 0.0), rank, 0).amax(
            dim=-1)[:, None, :]
    return color, final_t, depth, ncontrib


def blend_forward_reference(feats, tile_start, tile_stop, bg, tiles_x,
                            config: RasterConfig):
    """Plain torch K1 (see `_forward_reference`).

    feats [10, NK] f32 in (tile, depth) order; tile_start/stop [nt] int32;
    bg [3]. Returns (color [nt,3,P], final_T [nt,1,P], depth [nt,1,P],
    n_contrib [nt,1,P] int32) with P = tile * tile."""
    return _forward_reference(feats, tile_start, tile_stop, bg, tiles_x,
                              config)


_INV255 = torch.tensor(1.0 / 255.0, dtype=torch.float32).item()
_INV2047 = torch.tensor(1.0 / 2047.0, dtype=torch.float32).item()


def decode_eval_columns(cols: torch.Tensor, pack8: bool) -> torch.Tensor:
    """K3's decode, for its plain version: packed columns (int32 bit
    patterns, [5, NK], or [4, NK] under pack8) -> [9, NK] f32 rows x, y
    (tile-local), conic a/b/c, opacity, r, g, b. f16 halves decode exactly;
    pack8's 11-bit opacity and bytes as v * (1/2047) and v * (1/255) in
    f32, the JAX kernel's constants (blend.py:212-220)."""
    u = cols.to(torch.int64) & 0xFFFFFFFF
    lo = [_f16_from_bits(c) for c in u]
    hi = [_f16_from_bits(c >> 16) for c in u]
    rows = [lo[0], hi[0], lo[1], hi[1], lo[2]]
    if pack8:
        rows += [((u[2] >> 16) & 0x7FF).to(torch.float32) * _INV2047,
                 *(((u[3] >> s) & 0xFF).to(torch.float32) * _INV255
                   for s in (0, 8, 16))]
    else:
        rows += [hi[2], lo[3], hi[3], lo[4]]
    return torch.stack(rows)


def blend_forward_eval_packed_reference(cols, tile_start, tile_stop, bg,
                                        tiles_x, config: RasterConfig):
    """Plain torch K3: the colour of `_forward_reference` over the decoded
    columns, pixels and mean2d both tile-local. cols: [5, NK] int32 (f16
    layout) or [4, NK] (config.pack8). Returns color [nt, 3, P]."""
    return _forward_reference(decode_eval_columns(cols, config.pack8),
                              tile_start, tile_stop, bg, tiles_x, config,
                              tile_local=True, with_depth=False)[0]


def blend_forward_eval_reference(feats, tile_start, tile_stop, bg, tiles_x,
                                 config: RasterConfig):
    """Plain torch K4: the colour of `blend_forward_reference` (feats [10,
    NK] f32, the depth row unread). Returns color [nt, 3, P]."""
    return _forward_reference(feats, tile_start, tile_stop, bg, tiles_x,
                              config, with_depth=False)[0]


def blend_backward_reference(feats, tile_start, tile_stop, bg, tiles_x,
                             config: RasterConfig, dcolor, ddepth, dfinal_t,
                             final_t, ncontrib):
    """Plain torch K2: the explicit back-to-front gradient formula (not
    autograd of the forward, which would add the 0.99 clamp's subgradient
    that the reference's backward leaves out).

    A pixel takes instance i where i's index in the tile is below its
    n_contrib and i passed the forward's skips. With T_i = final_T / prod_
    {k>=i taken}(1 - alpha_k), w_i = alpha_i T_i, g_i = dL/dC . c_i +
    dL/dD . d_i and S_i = sum_{k>i} w_k g_k + final_T (bg . dL/dC + dL/dT):
    dalpha_i = T_i g_i - S_i / (1 - alpha_i), dpower_i = op G_i dalpha_i with
    the unclamped op G, and dL/d(rgb, depth)_i = w_i (dL/dC, dL/dD).

    Arguments as blend_forward_reference plus the cotangents dcolor
    [nt,3,P], ddepth and dfinal_t [nt,1,P] and the forward's final_T and
    n_contrib. Returns the per-instance gradients [10, NK] (rows as feats;
    columns outside every tile range are zero)."""
    dev = feats.device
    npix = config.tile * config.tile
    out = torch.zeros(feats.shape, dtype=torch.float32, device=dev)
    counts = (tile_stop - tile_start).tolist()
    bg_dot = torch.einsum("c,bcp->bp", bg.reshape(3), dcolor)
    for t0, t1, length in _tile_groups(counts, npix):
        idx, inside, f, dx, dy, opg, alpha = _group_alpha(
            feats, tile_start, counts, t0, t1, length, tiles_x, config)
        j = torch.arange(length, device=dev)
        taken = j < ncontrib[t0:t1, 0, :, None]  # [B, P, L]
        alpha = torch.where(taken, alpha, 0.0)
        opg = torch.where(taken, opg, 0.0)
        om = 1.0 - alpha
        suffix_prod = torch.cumprod(om.flip(-1), -1).flip(-1)
        T = final_t[t0:t1, 0, :, None]  # [B, P, 1]
        t_before = T / suffix_prod
        dld4 = torch.cat([dcolor[t0:t1], ddepth[t0:t1]], dim=1)  # [B, 4, P]
        g = torch.einsum("bcp,cbl->bpl", dld4, f[F_R:F_D + 1])
        w = alpha * t_before
        wg = w * g
        later = torch.cumsum(wg.flip(-1), -1).flip(-1) - wg
        s = later + T * (bg_dot[t0:t1] + dfinal_t[t0:t1, 0])[:, :, None]
        dalpha = torch.where(alpha > 0.0, t_before * g - s / om, 0.0)
        dpower = opg * dalpha

        ca, cb, cc = (f[r][:, None, :] for r in (F_CA, F_CB, F_CC))
        d0 = dpower.sum(1)
        op = f[F_OP]
        grads = torch.stack([
            -(dpower * (ca * dx + cb * dy)).sum(1),
            -(dpower * (cc * dy + cb * dx)).sum(1),
            (-0.5 * dx * dx * dpower).sum(1),
            (-dx * dy * dpower).sum(1),
            (-0.5 * dy * dy * dpower).sum(1),
            torch.where(op.abs() > 1e-20, d0 / op, 0.0),
            *torch.einsum("bcp,bpl->cbl", dld4, w),
        ])  # [10, B, L]
        out[:, idx[inside]] = grads[:, inside]
    return out


def _check_inputs(feats, tile_start, tile_stop, bg, tiles_x, rows=NFEAT,
                  dtype=torch.float32):
    if feats.dtype != dtype or feats.dim() != 2 or feats.shape[0] != rows:
        raise ValueError(f"feats must be [{rows}, NK] {dtype}, got "
                         f"{tuple(feats.shape)} {feats.dtype}")
    for name, x in (("tile_start", tile_start), ("tile_stop", tile_stop)):
        if x.dtype != torch.int32 or x.shape != tile_start.shape \
                or x.dim() != 1:
            raise ValueError(f"{name} must be [nt] int32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if bg.dtype != torch.float32 or bg.numel() != 3:
        raise ValueError(f"bg must be 3 float32 values, got {bg.shape}")
    if tile_start.shape[0] % tiles_x:
        raise ValueError(f"{tile_start.shape[0]} tiles is not a whole number "
                         f"of rows of {tiles_x}")
    devs = {x.device for x in (feats, tile_start, tile_stop, bg)}
    if len(devs) != 1:
        raise ValueError(f"blend inputs on several devices: {devs}")


def _check_cuda_launch(feats, config: RasterConfig):
    if not feats.is_cuda:
        raise ValueError("the blend kernels need CUDA tensors")
    npix = config.tile * config.tile
    if npix > 1024 or npix % 32:
        raise ValueError(f"tile {config.tile} needs {npix} threads a block; "
                         "the kernels take a multiple of 32, at most 1024")
    return npix


# The kernels' instances (csrc/blend_fwd.cu, blend_bwd.cu, blend_eval.cu):
# the pixels each thread owns
KERNEL_PIXELS = (1, 2)
# The tile counts from which the kernels take P = 2: for K1 and K2, four
# blocks of 2-pixel threads on each of the H100's 132 SMs; for K3 and K4
# eight, between render_views' 900 tiles and 640x480's 1,200 (see
# _pixels_per_thread).
_MANY_TILES = 4 * 132
_MANY_EVAL_TILES = 8 * 132


def _pixels_per_thread(num_tiles: int, many_tiles: int = _MANY_TILES) -> int:
    """P, the pixels each thread of a blend kernel owns: 2 on views with
    tiles enough to keep the card busy with half as many warps a tile
    (640x480: 1,200 tiles), 1 below that, where the walks are short and
    latency, not issue, bounds them (the trained 256x256 map: 256 tiles).
    Chosen from chip runs of tools/blend_ab.py (PERF.md): K1 and K2 switch
    at _MANY_TILES; the eval kernels K3 and K4 at _MANY_EVAL_TILES, since
    on render_views' 480x480 views (900 tiles, 134 instances a tile) K3
    took 0.0477 ms at P = 1 and 0.0507 ms at P = 2, and on the 640x480
    view (1,200 tiles, 219) 0.0834 and 0.0813 ms."""
    return 2 if num_tiles >= many_tiles else 1


def _check_blend_launch(feats, config: RasterConfig, num_tiles: int,
                        many_tiles: int = _MANY_TILES):
    """A kernel's launch: (pixels a tile, pixels a thread). The tiles
    divide a warp's 32 lanes (8, 16 or 32 with _check_cuda_launch's rule),
    where both values of P give whole warps."""
    npix = _check_cuda_launch(feats, config)
    if 32 % config.tile:
        raise ValueError(f"tile {config.tile}: the blend kernels take tiles "
                         "that divide a warp's 32 lanes")
    return npix, _pixels_per_thread(num_tiles, many_tiles)


def _on_device(kernel, plain, *args):
    """`kernel` (a kernel's launch) on CUDA tensors, `plain` (its plain
    version) on CPU tensors, as args[0] lies."""
    if args[0].is_cuda:
        return kernel(*args)
    if args[0].device.type == "cpu":
        return plain(*args)
    raise ValueError(f"no blend for device {args[0].device}")


def blend_forward(feats, tile_start, tile_stop, bg, tiles_x,
                  config: RasterConfig):
    """K1 on CUDA tensors; its plain version on CPU tensors. Same arguments
    and outputs as `blend_forward_reference`."""
    return _on_device(blend_forward_cuda, blend_forward_reference, feats,
                      tile_start, tile_stop, bg, tiles_x, config)


def blend_backward(feats, tile_start, tile_stop, bg, tiles_x,
                   config: RasterConfig, dcolor, ddepth, dfinal_t, final_t,
                   ncontrib):
    """K2 on CUDA tensors; its plain version on CPU tensors. Same arguments
    and output as `blend_backward_reference`."""
    return _on_device(blend_backward_cuda, blend_backward_reference, feats,
                      tile_start, tile_stop, bg, tiles_x, config, dcolor,
                      ddepth, dfinal_t, final_t, ncontrib)


def blend_forward_eval_packed(cols, tile_start, tile_stop, bg, tiles_x,
                              config: RasterConfig):
    """K3 on CUDA tensors; its plain version on CPU tensors. Same arguments
    and output as `blend_forward_eval_packed_reference`."""
    return _on_device(blend_forward_eval_packed_cuda,
                      blend_forward_eval_packed_reference, cols, tile_start,
                      tile_stop, bg, tiles_x, config)


def blend_forward_eval(feats, tile_start, tile_stop, bg, tiles_x,
                       config: RasterConfig):
    """K4 on CUDA tensors; its plain version on CPU tensors. Same arguments
    and output as `blend_forward_eval_reference`."""
    return _on_device(blend_forward_eval_cuda, blend_forward_eval_reference,
                      feats, tile_start, tile_stop, bg, tiles_x, config)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGTYPES = [_P, ctypes.c_longlong, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                 _F, _P, _P, _P, _P, _P]
_BWD_ARGTYPES = [_P, ctypes.c_longlong, _P, _P, _P, _I, _I, _I, _I, _F, _F,
                 _P, _P, _P, _P, _P, _P, _P]
_EVAL_ARGTYPES = [_P, _I, ctypes.c_longlong, _P, _P, _P, _I, _I, _I, _I, _F,
                  _F, _F, _P, _P]
# csrc/blend_eval.cu's input layouts
_EVAL_F32, _EVAL_F16, _EVAL_PACK8 = 0, 1, 2


def blend_forward_cuda(feats, tile_start, tile_stop, bg, tiles_x,
                       config: RasterConfig):
    """Launch K1 (csrc/blend_fwd.cu) on the current stream. Raises on a
    non-CUDA input or a failed launch; never falls back."""
    _check_inputs(feats, tile_start, tile_stop, bg, tiles_x)
    nt = tile_start.shape[0]
    npix, ppt = _check_blend_launch(feats, config, nt)
    feats = feats.contiguous()
    tile_start = tile_start.contiguous()
    tile_stop = tile_stop.contiguous()
    bg = bg.reshape(3).contiguous()
    dev = feats.device
    color = torch.empty((nt, 3, npix), dtype=torch.float32, device=dev)
    final_t = torch.empty((nt, 1, npix), dtype=torch.float32, device=dev)
    depth = torch.empty((nt, 1, npix), dtype=torch.float32, device=dev)
    ncontrib = torch.empty((nt, 1, npix), dtype=torch.int32, device=dev)
    launch("blend_fwd", "segs_blend_fwd", _FWD_ARGTYPES, dev, (
        feats.data_ptr(), feats.shape[1], tile_start.data_ptr(),
        tile_stop.data_ptr(), bg.data_ptr(), nt, tiles_x, config.tile, ppt,
        config.alpha_min, config.alpha_clamp, config.transmittance_min,
        color.data_ptr(), final_t.data_ptr(), depth.data_ptr(),
        ncontrib.data_ptr()))
    blend_forward_cuda.launches += 1
    return color, final_t, depth, ncontrib


blend_forward_cuda.launches = 0  # K1 launches, read by chip_smoke.py


def blend_backward_cuda(feats, tile_start, tile_stop, bg, tiles_x,
                        config: RasterConfig, dcolor, ddepth, dfinal_t,
                        final_t, ncontrib):
    """Launch K2 (csrc/blend_bwd.cu) on the current stream; the kernel
    writes every entry of the [10, NK] output, so it is not zero-filled
    here. Raises on a non-CUDA input or a failed launch; never falls
    back."""
    _check_inputs(feats, tile_start, tile_stop, bg, tiles_x)
    nt = tile_start.shape[0]
    npix, ppt = _check_blend_launch(feats, config, nt)
    per_pixel = (("dcolor", dcolor, 3, torch.float32),
                 ("ddepth", ddepth, 1, torch.float32),
                 ("dfinal_t", dfinal_t, 1, torch.float32),
                 ("final_t", final_t, 1, torch.float32),
                 ("ncontrib", ncontrib, 1, torch.int32))
    for name, x, c, dtype in per_pixel:
        if x.shape != (nt, c, npix) or x.dtype != dtype \
                or x.device != feats.device:
            raise ValueError(f"{name} must be [{nt}, {c}, {npix}] {dtype} on "
                             f"{feats.device}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
    feats, tile_start, tile_stop, dcolor, ddepth, dfinal_t, final_t, \
        ncontrib = (x.contiguous() for x in (
            feats, tile_start, tile_stop, dcolor, ddepth, dfinal_t, final_t,
            ncontrib))
    bg = bg.reshape(3).contiguous()
    dev = feats.device
    dfeats = torch.empty(feats.shape, dtype=torch.float32, device=dev)
    launch("blend_bwd", "segs_blend_bwd", _BWD_ARGTYPES, dev, (
        feats.data_ptr(), feats.shape[1], tile_start.data_ptr(),
        tile_stop.data_ptr(), bg.data_ptr(), nt, tiles_x, config.tile, ppt,
        config.alpha_min, config.alpha_clamp, dcolor.data_ptr(),
        ddepth.data_ptr(), dfinal_t.data_ptr(), final_t.data_ptr(),
        ncontrib.data_ptr(), dfeats.data_ptr()))
    blend_backward_cuda.launches += 1
    return dfeats


blend_backward_cuda.launches = 0  # K2 launches, read by chip_smoke.py


def _launch_eval(feats, layout, tile_start, tile_stop, bg, tiles_x,
                 config: RasterConfig):
    """One launch of csrc/blend_eval.cu (K3 or K4, by layout) on the
    current stream; returns color [nt, 3, P]."""
    nt = tile_start.shape[0]
    npix, ppt = _check_blend_launch(feats, config, nt, _MANY_EVAL_TILES)
    feats = feats.contiguous()
    tile_start = tile_start.contiguous()
    tile_stop = tile_stop.contiguous()
    bg = bg.reshape(3).contiguous()
    color = torch.empty((nt, 3, npix), dtype=torch.float32,
                        device=feats.device)
    launch("blend_eval", "segs_blend_eval", _EVAL_ARGTYPES, feats.device, (
        feats.data_ptr(), layout, feats.shape[1], tile_start.data_ptr(),
        tile_stop.data_ptr(), bg.data_ptr(), nt, tiles_x, config.tile, ppt,
        config.alpha_min, config.alpha_clamp, config.transmittance_min,
        color.data_ptr()))
    return color


def blend_forward_eval_packed_cuda(cols, tile_start, tile_stop, bg, tiles_x,
                                   config: RasterConfig):
    """Launch K3 (csrc/blend_eval.cu, the f16 or the pack8 layout as
    config.pack8 says) on the current stream. Raises on a non-CUDA input or
    a failed launch; never falls back."""
    rows = 4 if config.pack8 else 5
    _check_inputs(cols, tile_start, tile_stop, bg, tiles_x, rows, torch.int32)
    color = _launch_eval(cols, _EVAL_PACK8 if config.pack8 else _EVAL_F16,
                         tile_start, tile_stop, bg, tiles_x, config)
    blend_forward_eval_packed_cuda.launches += 1
    return color


blend_forward_eval_packed_cuda.launches = 0  # K3 launches, read by chip_smoke


def blend_forward_eval_cuda(feats, tile_start, tile_stop, bg, tiles_x,
                            config: RasterConfig):
    """Launch K4 (csrc/blend_eval.cu, the f32 layout) on the current
    stream. Raises on a non-CUDA input or a failed launch; never falls
    back."""
    _check_inputs(feats, tile_start, tile_stop, bg, tiles_x)
    color = _launch_eval(feats, _EVAL_F32, tile_start, tile_stop, bg,
                         tiles_x, config)
    blend_forward_eval_cuda.launches += 1
    return color


blend_forward_eval_cuda.launches = 0  # K4 launches, read by chip_smoke.py


# training blends by binning (RasterConfig.train_binning's "packed", "f32"
# or "exact"), read by chip_smoke.py
train_binnings = {"packed": 0, "f32": 0, "exact": 0}


def _count_binning(num_instances: torch.Tensor, num_compact: torch.Tensor,
                   config: RasterConfig) -> None:
    """While tracing: the visible gaussians beyond the static `compact`
    capacity, which the binning dropped; the exact binning drops none and
    counts its pairs and the gaussians it binned (device tensors, not
    waited for)."""
    if not tracing.enabled():
        return
    if config.exact:
        tracing.count("render.pairs", num_instances)
        tracing.count("render.binned_gaussians", num_compact)
        tracing.count("render.compact_dropped", 0)
    else:
        tracing.count("render.compact_dropped",
                      torch.clamp(num_compact - config.compact, min=0))


class _BinnedBlend(torch.autograd.Function):
    """Compaction + expansion + sort (the f32 or the packed training
    binning), or the exact binning, as RasterConfig.train_binning says, + K1
    forward; K2 + the gradient routing of the JAX `_binned_blend_bwd`
    backward."""

    @staticmethod
    def forward(ctx, feats, depth, bg, aux, config, tiles_x, tiles_y):
        aux = dict(aux, depth=depth)
        route = config.train_binning(tiles_x, tiles_y)
        with tracing.span("render.binning"):
            if route == "exact":
                binned, num_valid = bin_exact(feats, aux, tiles_x, tiles_y)
                orig_id = valid = None
            else:
                if route == "packed":
                    cg = compact_gaussians_packed(feats, aux, config,
                                                  with_orig=True)
                    binned = expand_and_sort_packed_train(cg, tiles_x,
                                                          tiles_y, config)
                else:
                    cg = compact_gaussians(feats, aux, config)
                    binned = expand_and_sort(cg, tiles_x, tiles_y, config)
                num_valid, orig_id, valid = cg.num_valid, cg.orig_id, cg.valid
            train_binnings[route] += 1
        _count_binning(binned.num_instances, num_valid, config)
        with tracing.span("render.blend"):
            color, final_t, depth_img, ncontrib = blend_forward(
                binned.feats_sorted, binned.tile_start, binned.tile_stop, bg,
                tiles_x, config)
        ctx.mark_non_differentiable(ncontrib, binned.num_instances,
                                    num_valid)
        ctx.save_for_backward(binned.feats_sorted, binned.tile_start,
                              binned.tile_stop, binned.gid_sorted, orig_id,
                              valid, bg, final_t, ncontrib)
        ctx.config, ctx.tiles_x, ctx.n = config, tiles_x, feats.shape[1]
        return (color, final_t, depth_img, ncontrib, binned.num_instances,
                num_valid)

    @staticmethod
    def backward(ctx, dcolor, dfinal_t, ddepth, *_):
        (feats_sorted, tile_start, tile_stop, gid_sorted, orig_id, valid, bg,
         final_t, ncontrib) = ctx.saved_tensors
        config, n = ctx.config, ctx.n
        with tracing.span("render.blend_bwd"):
            dinst = blend_backward(feats_sorted, tile_start, tile_stop, bg,
                                   ctx.tiles_x, config, dcolor, ddepth,
                                   dfinal_t, final_t, ncontrib)  # [10, NK]
            dev = dinst.device
            if config.exact:
                # the exact binning's instances name their gaussians' own
                # rows: one segment-sum
                dorig = torch.zeros((n, NFEAT), dtype=torch.float32,
                                    device=dev)
                dorig.index_add_(0, gid_sorted.long(), dinst.T)
            else:
                # segment-sum of the instance columns into their compact
                # gaussians, masked to the valid ones, then scattered back
                # through the compaction (unique destinations; invalid rows
                # go to a dropped row)
                dcompact = torch.zeros((config.compact, NFEAT),
                                       dtype=torch.float32, device=dev)
                dcompact.index_add_(0, gid_sorted.long(), dinst.T)
                dcompact = torch.where(valid[:, None], dcompact, 0.0)
                dorig = torch.zeros((n + 1, NFEAT), dtype=torch.float32,
                                    device=dev)
                dorig.index_add_(0, torch.where(valid, orig_id, n).long(),
                                 dcompact)
                dorig = dorig[:n]
            dbg = (final_t * dcolor).sum(dim=(0, 2))
        return (dorig[:, :NPAY].T, dorig[:, NPAY], dbg, None, None, None,
                None)


def binned_blend(feats: torch.Tensor, aux: dict, bg: torch.Tensor,
                 config: RasterConfig, tiles_x: int, tiles_y: int):
    """The JAX `binned_blend`, differentiable in `feats`, aux["depth"] and
    `bg`.

    feats: (NPAY, N) per-gaussian mean2d.x/y, conic a/b/c, opacity, r, g, b.
    aux: rect_min_x, rect_min_y, rect_w, touched (int32), depth (f32),
    alive (bool), each (N,); only depth carries a gradient (the
    expected-depth cotangent flows back through it). bg: (3,).
    The binning is RasterConfig.train_binning's: with config.packed_train,
    the packed one where the packed layouts fit (JAX's own gate), else the
    f32 one; with config.exact, the exact binning (no cap, no clamp), which
    counts its pairs and gaussians (`render.pairs`,
    `render.binned_gaussians`) while tracing.
    Returns (color [nt,3,P], final_T [nt,1,P], depth [nt,1,P],
    n_contrib [nt,1,P] int32, num_instances, num_compact)."""
    if config.sel_direct or config.pack8:
        raise ValueError("sel_direct and pack8 are eval binnings; the "
                         "training blend takes neither")
    rest = {k: v for k, v in aux.items() if k != "depth"}
    return _BinnedBlend.apply(feats, aux["depth"], bg.to(torch.float32), rest,
                              config, tiles_x, tiles_y)


def binned_blend_eval(feats: torch.Tensor, aux: dict, bg: torch.Tensor,
                      config: RasterConfig, tiles_x: int, tiles_y: int, *,
                      packed_kernel: bool = True):
    """The JAX `binned_blend_eval`: the no-gradient blend over the packed
    eval binning. With config.sel_direct, one selection sort over the raw
    rows (binning.bin_eval_direct) feeds K3; otherwise the packed compaction
    and instance sort feed K3 or, with packed_kernel=False, the unpacked f32
    rows feed K4 (JAX hard-codes packed_kernel = True).

    Arguments as `binned_blend`. Returns (color [nt,3,P], None, None, None,
    num_instances, num_compact): the eval kernels compute no final_T, depth
    or n_contrib image (JAX returns zeros there)."""
    bg = bg.to(torch.float32)
    if config.exact:
        raise ValueError("the exact binning has no packed eval layout; "
                         "render through binned_blend")
    if config.sel_direct and not packed_kernel:
        raise ValueError("the sel_direct binning feeds the packed kernel "
                         "only")
    with torch.no_grad():
        with tracing.span("render.binning"):
            if config.sel_direct:
                cols, start, stop, num_instances, num_compact = \
                    bin_eval_direct(feats, aux, tiles_x, tiles_y, config,
                                    return_packed=True)
            else:
                pc = compact_gaussians_packed(feats, aux, config)
                cols, start, stop, num_instances, _ = expand_and_sort_packed(
                    pc, tiles_x, tiles_y, config, return_packed=packed_kernel)
                num_compact = pc.num_valid
        _count_binning(num_instances, num_compact, config)
        with tracing.span("render.blend"):
            if packed_kernel:
                color = blend_forward_eval_packed(as_u32_bits(cols), start,
                                                  stop, bg, tiles_x, config)
            else:
                color = blend_forward_eval(cols, start, stop, bg, tiles_x,
                                           config)
    return color, None, None, None, num_instances, num_compact
