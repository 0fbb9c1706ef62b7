"""Tile blend forward: kernel K1 and its plain PyTorch version.

Port of the forward half of segs_slam_tpu/ops/rasterizer/blend.py
(`binned_blend` / `_binned_blend_fwd` around the Pallas kernel
`_fwd_kernel`). The kernel is hand-written CUDA for Hopper in
`csrc/blend_fwd.cu`; `blend_forward_reference` computes the same function in
plain torch. `blend_forward` launches the kernel for CUDA tensors and takes
the plain version only for tensors on the CPU.

The blend is forward-only for now: the backward kernel (K2) and the
autograd.Function around both come with the training slice, so
`binned_blend` refuses inputs that require grad while grad mode is on.

Sorted feature rows (the [10, NK] array):
  0: mean2d.x  1: mean2d.y  2: conic.a  3: conic.b  4: conic.c
  5: opacity   6: r  7: g  8: b  9: depth
"""

from __future__ import annotations

import ctypes

import torch

from segs_slam_tpu_torch.ops.cuda_lib import check, load_library
from segs_slam_tpu_torch.ops.rasterizer.binning import (
    NPAY,
    compact_gaussians,
    expand_and_sort,
)
from segs_slam_tpu_torch.ops.rasterizer.preprocess import RasterConfig

NFEAT = NPAY + 1
F_X, F_Y, F_CA, F_CB, F_CC, F_OP, F_R, F_G, F_B, F_D = range(NFEAT)

# Plain version: tiles are processed in groups of at most this many
# (tile, pixel, instance) elements per temporary.
_REF_GROUP_ELEMS = 1 << 24


def blend_forward_reference(feats, tile_start, tile_stop, bg, tiles_x,
                            config: RasterConfig):
    """Plain torch K1: per tile, alpha for every (pixel, instance), then
    T = cumprod(1 - alpha), accept = T >= transmittance_min (a prefix, which
    is the reference's latch), weights alpha * T_before.

    feats [10, NK] f32 in (tile, depth) order; tile_start/stop [nt] int32;
    bg [3]. Returns (color [nt,3,P], final_T [nt,1,P], depth [nt,1,P],
    n_contrib [nt,1,P] int32) with P = tile * tile."""
    dev = feats.device
    nt = tile_start.shape[0]
    b = config.tile
    npix = b * b
    color = bg.reshape(1, 3, 1).expand(nt, 3, npix).clone()
    final_t = torch.ones((nt, 1, npix), dtype=torch.float32, device=dev)
    depth = torch.zeros((nt, 1, npix), dtype=torch.float32, device=dev)
    ncontrib = torch.zeros((nt, 1, npix), dtype=torch.int32, device=dev)

    counts = (tile_stop - tile_start).tolist()
    p = torch.arange(npix, device=dev)
    local_x, local_y = (p % b).float(), (p // b).float()

    t0 = 0
    while t0 < nt:
        t1, longest = t0 + 1, counts[t0]
        while t1 < nt and (t1 - t0 + 1) * npix * max(longest, counts[t1]) \
                <= _REF_GROUP_ELEMS:
            longest = max(longest, counts[t1])
            t1 += 1
        if longest > 0:
            _blend_group(feats, tile_start[t0:t1], longest, bg, tiles_x, t0,
                         local_x, local_y, config, color[t0:t1],
                         final_t[t0:t1], depth[t0:t1], ncontrib[t0:t1],
                         counts[t0:t1])
        t0 = t1
    return color, final_t, depth, ncontrib


def _blend_group(feats, start, length, bg, tiles_x, t0, local_x, local_y,
                 config, color, final_t, depth, ncontrib, counts):
    """Blend tiles [t0, t0 + len(start)) into the given output slices."""
    dev = feats.device
    nb = start.shape[0]
    b = config.tile
    j = torch.arange(length, device=dev)
    count = torch.tensor(counts, device=dev)
    inside = j[None, :] < count[:, None]  # [B, L]
    idx = torch.where(inside, start[:, None].long() + j[None, :], 0)
    f = feats[:, idx]  # [10, B, L]

    t = torch.arange(t0, t0 + nb, device=dev)
    pix_x = ((t % tiles_x) * b).float()[:, None] + local_x[None, :]  # [B, P]
    pix_y = ((t // tiles_x) * b).float()[:, None] + local_y[None, :]
    dx = f[F_X][:, None, :] - pix_x[:, :, None]  # [B, P, L]
    dy = f[F_Y][:, None, :] - pix_y[:, :, None]
    power = (-0.5 * (f[F_CA][:, None, :] * dx * dx
                     + f[F_CC][:, None, :] * dy * dy)
             - f[F_CB][:, None, :] * dx * dy)
    alpha = torch.clamp(f[F_OP][:, None, :] * torch.exp(power),
                        max=config.alpha_clamp)
    ok = inside[:, None, :] & (power <= 0.0) & (alpha >= config.alpha_min)
    alpha = torch.where(ok, alpha, 0.0)

    cum = torch.cumprod(1.0 - alpha, dim=-1)  # T after each instance
    t_before = torch.cat([torch.ones_like(cum[..., :1]), cum[..., :-1]], -1)
    accept = cum >= config.transmittance_min
    w = torch.where(accept, alpha * t_before, 0.0)  # [B, P, L]
    T = torch.where(accept, cum, 1.0).amin(dim=-1)  # [B, P]

    rgb = f[F_R:F_B + 1]  # [3, B, L]
    color.copy_(torch.einsum("bpl,cbl->bcp", w, rgb)
                + bg.reshape(1, 3, 1) * T[:, None, :])
    final_t.copy_(T[:, None, :])
    depth.copy_(torch.einsum("bpl,bl->bp", w, f[F_D])[:, None, :])
    rank = (j + 1).to(torch.int32)
    ncontrib.copy_(torch.where(accept & (alpha > 0.0), rank, 0)
                   .amax(dim=-1)[:, None, :])


def _check_inputs(feats, tile_start, tile_stop, bg, tiles_x):
    if feats.dtype != torch.float32 or feats.dim() != 2 \
            or feats.shape[0] != NFEAT:
        raise ValueError(f"feats must be [{NFEAT}, NK] float32, got "
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


def blend_forward(feats, tile_start, tile_stop, bg, tiles_x,
                  config: RasterConfig):
    """K1 on CUDA tensors; its plain version on CPU tensors. Same arguments
    and outputs as `blend_forward_reference`."""
    if feats.is_cuda:
        return blend_forward_cuda(feats, tile_start, tile_stop, bg, tiles_x,
                                  config)
    if feats.device.type == "cpu":
        return blend_forward_reference(feats, tile_start, tile_stop, bg,
                                       tiles_x, config)
    raise ValueError(f"no blend for device {feats.device}")


def _blend_library():
    lib = load_library("blend_fwd")
    fn = lib.segs_blend_fwd
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, ctypes.c_longlong, p, p, p, i, i, i, f, f, f,
                       p, p, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def blend_forward_cuda(feats, tile_start, tile_stop, bg, tiles_x,
                       config: RasterConfig):
    """Launch K1 (csrc/blend_fwd.cu) on the current stream. Raises on a
    non-CUDA input or a failed launch; never falls back."""
    _check_inputs(feats, tile_start, tile_stop, bg, tiles_x)
    if not feats.is_cuda:
        raise ValueError("blend_forward_cuda needs CUDA tensors")
    npix = config.tile * config.tile
    if npix > 1024:
        raise ValueError(f"tile {config.tile} needs {npix} threads a block; "
                         "the kernel takes at most 1024")
    lib = _blend_library()
    feats = feats.contiguous()
    tile_start = tile_start.contiguous()
    tile_stop = tile_stop.contiguous()
    bg = bg.reshape(3).contiguous()
    nt = tile_start.shape[0]
    dev = feats.device
    color = torch.empty((nt, 3, npix), dtype=torch.float32, device=dev)
    final_t = torch.empty((nt, 1, npix), dtype=torch.float32, device=dev)
    depth = torch.empty((nt, 1, npix), dtype=torch.float32, device=dev)
    ncontrib = torch.empty((nt, 1, npix), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.segs_blend_fwd(
            feats.data_ptr(), feats.shape[1], tile_start.data_ptr(),
            tile_stop.data_ptr(), bg.data_ptr(), nt, tiles_x, config.tile,
            config.alpha_min, config.alpha_clamp, config.transmittance_min,
            color.data_ptr(), final_t.data_ptr(), depth.data_ptr(),
            ncontrib.data_ptr(), stream)
    check(lib, code, "blend_fwd launch")
    blend_forward_cuda.launches += 1
    return color, final_t, depth, ncontrib


blend_forward_cuda.launches = 0  # K1 launches, read by chip_smoke.py


def binned_blend(feats: torch.Tensor, aux: dict, bg: torch.Tensor,
                 config: RasterConfig, tiles_x: int, tiles_y: int):
    """Forward half of the JAX `binned_blend`.

    feats: (NPAY, N) per-gaussian mean2d.x/y, conic a/b/c, opacity, r, g, b.
    aux: rect_min_x, rect_min_y, rect_w, touched (int32), depth (f32),
    alive (bool), each (N,). bg: (3,). Returns (color [nt,3,P],
    final_T [nt,1,P], depth [nt,1,P], n_contrib [nt,1,P] int32,
    num_instances, num_compact)."""
    if config.packed_train or config.sel_direct or config.pack8:
        raise ValueError("the packed binning is not ported; use a config "
                         "with packed_train, sel_direct and pack8 off")
    if torch.is_grad_enabled() and (feats.requires_grad
                                    or aux["depth"].requires_grad):
        raise RuntimeError("binned_blend is forward-only (no backward "
                           "kernel yet); call it under torch.inference_mode()")
    cg = compact_gaussians(feats, aux, config)
    binned = expand_and_sort(cg, tiles_x, tiles_y, config)
    color, final_t, depth, ncontrib = blend_forward(
        binned.feats_sorted, binned.tile_start, binned.tile_stop,
        bg.to(torch.float32), tiles_x, config)
    return (color, final_t, depth, ncontrib, binned.num_instances,
            cg.num_valid)
