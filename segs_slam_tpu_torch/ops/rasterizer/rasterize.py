"""Top-level differentiable tile rasterizer.

Port of segs_slam_tpu/ops/rasterizer/rasterize.py:

    preprocess (torch autograd; kernel K5 where no
      gradient is asked)                             forward.cu:154-256
      -> compaction + kmax expansion + (tile, depth) sort
      -> tile blend, kernels K1 / K2 inside one
         autograd.Function (blend.py)                forward.cu:339-452,
                                                     backward.cu:399-557

Gradients reach means3d, scales, rotations, opacities, colours (or SH
coefficients) and mean2d_offset through autograd and that one Function.
"""

from __future__ import annotations

import ctypes

import torch

from segs_slam_tpu_torch.ops.cuda_lib import check, load_library
from segs_slam_tpu_torch.ops.rasterizer.blend import NPAY, binned_blend
from segs_slam_tpu_torch.ops.rasterizer.preprocess import (
    GaussianProjection,
    RasterConfig,
    compute_cov3d,
    preprocess_gaussians,
)
from segs_slam_tpu_torch.utils import tracing


def blend_inputs(proj, opacities, colors, mean2d_offset=None):
    """(feats [NPAY, N], aux) for binned_blend from a GaussianProjection."""
    mean2d = proj.mean2d
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset
    feats = torch.stack([
        mean2d[:, 0], mean2d[:, 1],
        proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
        opacities.reshape(-1),
        colors[:, 0], colors[:, 1], colors[:, 2],
    ])
    aux = {
        "rect_min_x": proj.rect_min[:, 0],
        "rect_min_y": proj.rect_min[:, 1],
        "rect_w": proj.rect_max[:, 0] - proj.rect_min[:, 0],
        "touched": proj.tiles_touched.to(torch.int32),
        "depth": proj.depth,
        "alive": proj.radius > 0,
    }
    return feats, aux


def uses_preprocess_kernel(inputs, *, grad_free: bool = False) -> bool:
    """Whether a preprocess call takes K5 (`preprocess_cuda`) rather than its
    plain twin, the eager chain compute_cov3d + preprocess_gaussians (+
    blend_inputs): its first input lies on a CUDA device and, with
    grad_free (the projection, whose outputs would carry gradients), no
    gradient is asked: grad mode off, or no tensor of `inputs` requiring
    one. Decided by the device and the gradient alone; nothing else selects
    the route. On the card K5 raises on an input it cannot take (not
    float32, a mask that is not bool, another device) rather than fall
    back."""
    if not inputs[0].is_cuda:
        return False
    if grad_free and torch.is_grad_enabled():
        return not any(isinstance(t, torch.Tensor) and t.requires_grad
                       for t in inputs)
    return True


_K5_CAMERA_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ctypes.c_float]
_K5_ENTRIES = {
    "segs_preprocess_mask": _K5_CAMERA_ARGTYPES + [ctypes.c_void_p] * 2,
    "segs_preprocess": _K5_CAMERA_ARGTYPES + [ctypes.c_void_p] * 10,
}
# Rows of K5's int32 output (csrc/preprocess.cu: Params::ints)
_RADIUS, _MIN_X, _MIN_Y, _MAX_X, _MAX_Y, _TOUCHED, _RECT_W = range(7)


def _fov_axis(tan, size: int):
    """(device pointer, focal, limit) of one axis for K5: a 0-d CUDA tan_fov
    goes by pointer (the kernel computes both from it); a host value gives
    `size / (2.0 * tan)` and `1.3 * tan` evaluated as preprocess_gaussians
    evaluates them, which the f32 argument rounds as torch rounds a
    number meeting a float32 tensor."""
    if isinstance(tan, torch.Tensor) and tan.is_cuda:
        return tan.data_ptr(), 0.0, 0.0
    return None, float(size / (2.0 * tan)), float(1.3 * tan)


def preprocess_cuda(means3d, scales, rotations, world_view_transform,
                    full_proj_transform, width: int, height: int, tan_fovx,
                    tan_fovy, config: RasterConfig, valid=None,
                    opacities=None, colors=None, mean2d_offset=None,
                    scale_modifier: float = 1.0):
    """Launch K5 (csrc/preprocess.cu) on the current stream, for CUDA inputs
    (`uses_preprocess_kernel`). Without colours: the mask radius > 0
    (`visible_filter`'s). With opacities and colours: (GaussianProjection,
    feats, aux) as `project` returns them, the projection's fields views of
    the blend rows where they hold the same values. Either equals its
    plain twin bit for bit. Raises on a bad shape, a type other than float32
    (bool for `valid`), a tensor off the first input's CUDA device or a
    failed launch; never falls back."""
    n = means3d.shape[0]
    full = colors is not None
    f32 = torch.float32
    shapes = [("means3d", means3d, (n, 3), f32),
              ("scales", scales, (n, 3), f32),
              ("rotations", rotations, (n, 4), f32),
              ("world_view_transform", world_view_transform, (4, 4), f32),
              ("full_proj_transform", full_proj_transform, (4, 4), f32)]
    if valid is not None:
        shapes.append(("valid", valid, (n,), torch.bool))
    if full:
        opacities = opacities.reshape(-1)
        shapes += [("opacities", opacities, (n,), f32),
                   ("colors", colors, (n, 3), f32)]
        if mean2d_offset is not None:
            shapes.append(("mean2d_offset", mean2d_offset, (n, 2), f32))
    for tan, name in ((tan_fovx, "tan_fovx"), (tan_fovy, "tan_fovy")):
        if isinstance(tan, torch.Tensor) and tan.is_cuda:
            shapes.append((name, tan.reshape(-1), (1,), f32))
    for name, x, shape, dtype in shapes:
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
    dev = means3d.device
    for name, x, _, _ in shapes:
        if x.device != dev or not x.is_cuda:
            raise ValueError(f"K5 needs every tensor on one CUDA device; "
                             f"{name} is on {x.device}")
    tan_x, focal_x, lim_x = _fov_axis(tan_fovx, width)
    tan_y, focal_y, lim_y = _fov_axis(tan_fovy, height)
    tiles_x, tiles_y = config.grid(width, height)

    held = []  # the contiguous inputs, alive until the launch is queued

    def ptr(x):
        if x is None:
            return None
        held.append(x.detach().contiguous())
        return held[-1].data_ptr()

    camera = (ptr(means3d), ptr(scales), ptr(rotations), ptr(valid), n,
              ptr(world_view_transform), ptr(full_proj_transform), tan_x,
              tan_y, focal_x, focal_y, lim_x, lim_y, width, height, tiles_x,
              tiles_y, config.kmax, float(config.tile), 1.0 / config.tile,
              config.near, scale_modifier)
    entry = "segs_preprocess" if full else "segs_preprocess_mask"
    lib = load_library("preprocess")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = _K5_ENTRIES[entry]
        fn.restype = ctypes.c_int
    if full:
        rows = torch.empty((NPAY + 1, n), dtype=torch.float32, device=dev)
        feats, depth = rows[:NPAY], rows[NPAY]
        mean2d = (feats[:2] if mean2d_offset is None else
                  torch.empty((2, n), dtype=torch.float32, device=dev))
        ints = torch.empty((7, n), dtype=torch.int32, device=dev)
        alive = torch.empty(n, dtype=torch.bool, device=dev)
        kmax_truncated = torch.empty((), dtype=torch.int32, device=dev)
        outs = (ptr(opacities), ptr(colors), ptr(mean2d_offset),
                feats.data_ptr(), depth.data_ptr(),
                None if mean2d_offset is None else mean2d.data_ptr(),
                ints.data_ptr(), alive.data_ptr(), kmax_truncated.data_ptr())
    else:
        visible = torch.empty(n, dtype=torch.bool, device=dev)
        outs = (visible.data_ptr(),)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(*camera, *outs, stream)
    check(lib, code, f"{entry} launch")
    preprocess_cuda.launches += 1
    if not full:
        return visible
    proj = GaussianProjection(
        mean2d=mean2d.T, conic=feats[2:5].T, depth=depth,
        radius=ints[_RADIUS], rect_min=ints[_MIN_X:_MIN_Y + 1].T,
        rect_max=ints[_MAX_X:_MAX_Y + 1].T, tiles_touched=ints[_TOUCHED],
        kmax_truncated=kmax_truncated)
    aux = {"rect_min_x": ints[_MIN_X], "rect_min_y": ints[_MIN_Y],
           "rect_w": ints[_RECT_W], "touched": ints[_TOUCHED],
           "depth": depth, "alive": alive}
    return proj, feats, aux


preprocess_cuda.launches = 0  # K5 launches (both entries)


def tiles_to_image(x, tx, ty, b, width, height):
    """[nt, C, b*b] tile-major -> [C, H, W]."""
    c = x.shape[1]
    return (x.reshape(ty, tx, c, b, b).permute(2, 0, 3, 1, 4)
            .reshape(c, ty * b, tx * b)[:, :height, :width])


def project(
    means3d: torch.Tensor,  # (N, 3)
    scales: torch.Tensor,  # (N, 3) linear (already exp'd)
    rotations: torch.Tensor,  # (N, 4) normalized quats (w,x,y,z)
    opacities: torch.Tensor,  # (N,) or (N, 1)
    colors: torch.Tensor,  # (N, 3) precomputed colors
    world_view_transform: torch.Tensor,  # (4, 4) W2C^T
    full_proj_transform: torch.Tensor,  # (4, 4)
    width: int,
    height: int,
    tan_fovx,
    tan_fovy,
    config: RasterConfig = RasterConfig(),
    valid: torch.Tensor | None = None,  # (N,) bool mask for padded buffers
    mean2d_offset: torch.Tensor | None = None,  # (N, 2)
    scale_modifier: float = 1.0,
):
    """The front half of `rasterize`: (GaussianProjection, feats, aux), the
    blends' inputs (see `blend_inputs`). K5 computes them where no
    gradient is asked of CUDA inputs (`uses_preprocess_kernel`), the eager
    autograd chain otherwise; the two agree bit for bit."""
    inputs = (means3d, scales, rotations, opacities, colors,
              world_view_transform, full_proj_transform, tan_fovx, tan_fovy,
              mean2d_offset)
    with tracing.span("render.project"):
        if uses_preprocess_kernel(inputs, grad_free=True):
            tracing.count("render.preprocess_kernel", 1)
            proj, feats, aux = preprocess_cuda(
                means3d, scales, rotations, world_view_transform,
                full_proj_transform, width, height, tan_fovx, tan_fovy,
                config, valid, opacities, colors, mean2d_offset,
                scale_modifier)
        else:
            tracing.count("render.preprocess_eager", 1)
            cov3d = compute_cov3d(scales, rotations, scale_modifier)
            proj = preprocess_gaussians(
                means3d, cov3d, world_view_transform, full_proj_transform,
                width, height, tan_fovx, tan_fovy, config, valid_in=valid)
            feats, aux = blend_inputs(proj, opacities, colors, mean2d_offset)
    tracing.count("render.kmax_truncated", proj.kmax_truncated)
    return proj, feats, aux


def blend_projected(proj, feats, aux, bg: torch.Tensor, width: int,
                    height: int, config: RasterConfig) -> dict:
    """The back half of `rasterize`: the differentiable blend of `project`'s
    outputs, as images."""
    tx, ty = config.grid(width, height)
    color, final_t, depth_img, ncontrib, num_instances, num_compact = (
        binned_blend(feats, aux, bg, config, tx, ty))

    b = config.tile
    if config.ksmall:
        num_large = ((torch.clamp(proj.tiles_touched, max=config.kmax)
                      > config.ksmall) & (proj.radius > 0)).sum(
                          dtype=torch.int32)
    else:
        num_large = torch.zeros((), dtype=torch.int32, device=color.device)
    return {
        "image": tiles_to_image(color, tx, ty, b, width, height),
        "radii": proj.radius,
        "final_T": tiles_to_image(final_t, tx, ty, b, width, height)[0],
        "n_contrib": tiles_to_image(ncontrib, tx, ty, b, width, height)[0],
        "depth_map": tiles_to_image(depth_img, tx, ty, b, width, height)[0],
        "num_instances": num_instances,
        "num_compact": num_compact,
        "num_kmax_truncated": proj.kmax_truncated,
        "num_large": num_large,
        "depth": proj.depth,
    }


def rasterize(
    means3d: torch.Tensor,  # (N, 3)
    scales: torch.Tensor,  # (N, 3) linear (already exp'd)
    rotations: torch.Tensor,  # (N, 4) normalized quats (w,x,y,z)
    opacities: torch.Tensor,  # (N,) or (N, 1)
    colors: torch.Tensor,  # (N, 3) precomputed colors
    world_view_transform: torch.Tensor,  # (4, 4) W2C^T
    full_proj_transform: torch.Tensor,  # (4, 4)
    width: int,
    height: int,
    tan_fovx,
    tan_fovy,
    bg: torch.Tensor,  # (3,)
    config: RasterConfig = RasterConfig(),
    valid: torch.Tensor | None = None,  # (N,) bool mask for padded buffers
    mean2d_offset: torch.Tensor | None = None,  # (N, 2)
    scale_modifier: float = 1.0,
    shs: torch.Tensor | None = None,  # (N, K, 3) SH coeffs; overrides colors
    sh_degree: int = 3,
    campos: torch.Tensor | None = None,  # (3,); derived when None
) -> dict:
    """Returns dict with image (3, H, W), radii (N,), final_T, n_contrib,
    depth_map, num_instances, num_compact, num_kmax_truncated, num_large,
    depth; the same keys and layouts as the JAX version. With `shs`, the
    colours are sh_to_color's at the camera position (reference:
    computeColorFromSH, forward.cu:20-71; unused by the reference's live
    renderer but part of its kernels' surface)."""
    if shs is not None:
        from segs_slam_tpu_torch.ops.sh import sh_to_color

        if campos is None:
            # the camera centre: the last row of inv(W2C^T) = (-R^T t, 1)
            campos = torch.linalg.inv(world_view_transform)[3, :3]
        colors = sh_to_color(sh_degree, shs, means3d, campos)
    proj, feats, aux = project(
        means3d, scales, rotations, opacities, colors, world_view_transform,
        full_proj_transform, width, height, tan_fovx, tan_fovy, config,
        valid, mean2d_offset, scale_modifier)
    return blend_projected(proj, feats, aux, bg, width, height, config)


def visible_filter(
    means3d: torch.Tensor,
    scales: torch.Tensor,  # (N, 3) linear
    rotations: torch.Tensor,  # (N, 4) normalized
    world_view_transform: torch.Tensor,
    full_proj_transform: torch.Tensor,
    width: int,
    height: int,
    tan_fovx,
    tan_fovy,
    config: RasterConfig = RasterConfig(),
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Anchor visibility prefilter: radii > 0, no blending (reference:
    GaussianRenderer::prefilter_voxel, src/gaussian_renderer.cpp:131-199).
    K5's mask entry on CUDA inputs (the mask carries no gradient), the
    eager chain otherwise."""
    if uses_preprocess_kernel((means3d,)):
        tracing.count("render.preprocess_kernel", 1)
        return preprocess_cuda(
            means3d, scales, rotations, world_view_transform,
            full_proj_transform, width, height, tan_fovx, tan_fovy, config,
            valid)
    tracing.count("render.preprocess_eager", 1)
    cov3d = compute_cov3d(scales, rotations, 1.0)
    proj = preprocess_gaussians(
        means3d.detach(), cov3d.detach(), world_view_transform,
        full_proj_transform, width, height, tan_fovx, tan_fovy, config,
        valid_in=valid)
    return proj.radius > 0
