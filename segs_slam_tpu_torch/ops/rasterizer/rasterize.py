"""Top-level differentiable tile rasterizer.

Port of segs_slam_tpu/ops/rasterizer/rasterize.py:

    preprocess (on the card kernels K5 forward and K6
      backward inside one autograd.Function; on the
      CPU the eager autograd chain)                  forward.cu:154-256
      -> compaction + kmax expansion + (tile, depth) sort
      -> tile blend, kernels K1 / K2 inside one
         autograd.Function (blend.py)                forward.cu:339-452,
                                                     backward.cu:399-557

Gradients reach means3d, scales, rotations, opacities, colours (or SH
coefficients), mean2d_offset and the camera (world_view_transform,
full_proj_transform, 0-d tan_fov tensors) through those two Functions, or
through autograd and the blend's Function on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from segs_slam_tpu_torch.ops.cuda_lib import launch
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


def uses_preprocess_kernel(means3d: torch.Tensor) -> bool:
    """Whether a preprocess call takes the hand-written kernels rather than
    their plain twin, the eager chain compute_cov3d + preprocess_gaussians
    (+ blend_inputs) differentiated by autograd: K5 (`preprocess_cuda`) for
    the values and, for the projection's gradient, K6
    (`preprocess_backward_cuda`). Decided by the device alone: means3d lies
    on a CUDA device. On the card the kernels raise on an input they cannot
    take (not float32, a mask that is not bool, another device, a host
    tan_fov tensor that asks a gradient) rather than fall back."""
    return means3d.is_cuda


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
    """(device pointer, focal, limit) of one axis for K5 and K6: a 0-d CUDA
    tan_fov goes by pointer (the kernel computes both from it); a host
    value gives `size / (2.0 * tan)` and `1.3 * tan` evaluated as
    preprocess_gaussians evaluates them, which the f32 argument rounds as
    torch rounds a number meeting a float32 tensor."""
    if isinstance(tan, torch.Tensor) and tan.is_cuda:
        return tan.data_ptr(), 0.0, 0.0
    return None, float(size / (2.0 * tan)), float(1.3 * tan)


def _launch_preprocess(means3d, scales, rotations, world_view_transform,
                       full_proj_transform, width: int, height: int,
                       tan_fovx, tan_fovy, config: RasterConfig, valid=None,
                       opacities=None, colors=None, mean2d_offset=None,
                       scale_modifier: float = 1.0):
    """K5's launch (see `preprocess_cuda`): the mask, or the full entry's
    outputs (feats [NPAY, N], depth [N], mean2d [2, N] with an offset else
    None, the int32 rows [7, N], alive [N], kmax_truncated ())."""
    n = means3d.shape[0]
    full = colors is not None
    f32 = torch.float32
    shapes = _camera_shapes(means3d, scales, rotations, world_view_transform,
                            full_proj_transform, tan_fovx, tan_fovy)
    if valid is not None:
        shapes.append(("valid", valid, (n,), torch.bool))
    if full:
        opacities = opacities.reshape(-1)
        shapes += [("opacities", opacities, (n,), f32),
                   ("colors", colors, (n, 3), f32)]
        if mean2d_offset is not None:
            shapes.append(("mean2d_offset", mean2d_offset, (n, 2), f32))
    _check_inputs(shapes, "K5")
    dev = means3d.device
    tan_x, focal_x, lim_x = _fov_axis(tan_fovx, width)
    tan_y, focal_y, lim_y = _fov_axis(tan_fovy, height)
    tiles_x, tiles_y = config.grid(width, height)

    held = []  # the contiguous inputs, alive until the launch is queued
    ptr = _pointers(held)
    camera = (ptr(means3d), ptr(scales), ptr(rotations), ptr(valid), n,
              ptr(world_view_transform), ptr(full_proj_transform), tan_x,
              tan_y, focal_x, focal_y, lim_x, lim_y, width, height, tiles_x,
              tiles_y, config.kmax, float(config.tile), 1.0 / config.tile,
              config.near, scale_modifier)
    entry = "segs_preprocess" if full else "segs_preprocess_mask"
    if full:
        rows = torch.empty((NPAY + 1, n), dtype=f32, device=dev)
        feats, depth = rows[:NPAY], rows[NPAY]
        mean2d = (None if mean2d_offset is None else
                  torch.empty((2, n), dtype=f32, device=dev))
        ints = torch.empty((7, n), dtype=torch.int32, device=dev)
        alive = torch.empty(n, dtype=torch.bool, device=dev)
        kmax_truncated = torch.empty((), dtype=torch.int32, device=dev)
        outs = (ptr(opacities), ptr(colors), ptr(mean2d_offset),
                feats.data_ptr(), depth.data_ptr(), ptr(mean2d),
                ints.data_ptr(), alive.data_ptr(), kmax_truncated.data_ptr())
    else:
        visible = torch.empty(n, dtype=torch.bool, device=dev)
        outs = (visible.data_ptr(),)
    launch("preprocess", entry, _K5_ENTRIES[entry], dev, camera + outs)
    preprocess_cuda.launches += 1
    if not full:
        return visible
    return feats, depth, mean2d, ints, alive, kmax_truncated


def _projection(feats, depth, mean2d, ints, alive, kmax_truncated):
    """(GaussianProjection, feats, aux) as `project` returns them, from K5's
    full entry's outputs: the projection's fields views of the blend rows
    where they hold the same values."""
    proj = GaussianProjection(
        mean2d=(feats[:2] if mean2d is None else mean2d).T,
        conic=feats[2:5].T, depth=depth, radius=ints[_RADIUS],
        rect_min=ints[_MIN_X:_MIN_Y + 1].T,
        rect_max=ints[_MAX_X:_MAX_Y + 1].T, tiles_touched=ints[_TOUCHED],
        kmax_truncated=kmax_truncated)
    aux = {"rect_min_x": ints[_MIN_X], "rect_min_y": ints[_MIN_Y],
           "rect_w": ints[_RECT_W], "touched": ints[_TOUCHED],
           "depth": depth, "alive": alive}
    return proj, feats, aux


def preprocess_cuda(means3d, scales, rotations, world_view_transform,
                    full_proj_transform, width: int, height: int, tan_fovx,
                    tan_fovy, config: RasterConfig, valid=None,
                    opacities=None, colors=None, mean2d_offset=None,
                    scale_modifier: float = 1.0):
    """Launch K5 (csrc/preprocess.cu) on the current stream, for CUDA inputs
    (`uses_preprocess_kernel`), with no gradient. Without colours: the mask
    radius > 0 (`visible_filter`'s). With opacities and colours:
    (GaussianProjection, feats, aux) as `project` returns them, the
    projection's fields views of the blend rows where they hold the same
    values. Either equals its plain twin bit for bit. Raises on a bad shape,
    a type other than float32 (bool for `valid`), a tensor off the first
    input's CUDA device or a failed launch; never falls back."""
    with torch.no_grad():
        out = _launch_preprocess(
            means3d, scales, rotations, world_view_transform,
            full_proj_transform, width, height, tan_fovx, tan_fovy, config,
            valid, opacities, colors, mean2d_offset, scale_modifier)
    return out if colors is None else _projection(*out)


preprocess_cuda.launches = 0  # K5 launches (both entries)


_K6_ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 4
    + [ctypes.c_float] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float]
    + [ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
    + [ctypes.c_longlong] + [ctypes.c_void_p] + [ctypes.c_longlong] * 2
    + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 4)
# K6's blocks at most (csrc/preprocess_bwd.cu: a grid-stride loop), and its
# camera terms a gaussian, whose block sums it keeps in a scratch buffer
_K6_MAX_BLOCKS, _K6_CAMERA_TERMS = 4096, 28


def preprocess_backward_cuda(means3d, scales, rotations,
                             world_view_transform, full_proj_transform,
                             width: int, height: int, tan_fovx, tan_fovy,
                             d_feats, d_depth, d_mean2d=None,
                             scale_modifier: float = 1.0,
                             needs=(True, True, True, True)):
    """Launch K6 (csrc/preprocess_bwd.cu) on the current stream: the
    gradient of K5's full entry (`project` on the card) from the cotangents
    of the blend rows d_feats [NPAY, N] (rows 0-4 read: the opacity and
    colour rows are their inputs' gradients as they are), of depth [N] and,
    with an offset, of mean2d [2, N], each read through its strides and
    None where no gradient reached it. `needs`: (means3d, scales, rotations,
    the camera). Returns the gradients of (means3d, scales, rotations,
    world_view_transform, full_proj_transform, tan_fovx, tan_fovy), each
    None where not asked or not reached (tan_fovx / tan_fovy: their 0-d
    gradient where they are device tensors); the camera's in a second
    launch, by a fixed-order sum. The gradient is the eager chain's
    autograd gradient within rounding, non-finite exactly where the chain's
    is. Raises as K5 does, and on a cotangent of another shape or type."""
    n = means3d.shape[0]
    f32 = torch.float32
    shapes = _camera_shapes(means3d, scales, rotations, world_view_transform,
                            full_proj_transform, tan_fovx, tan_fovy)
    for name, x, shape in (("d_feats", d_feats, (NPAY, n)),
                           ("d_depth", d_depth, (n,)),
                           ("d_mean2d", d_mean2d, (2, n))):
        if x is not None:
            shapes.append((name, x, shape, f32))
    _check_inputs(shapes, "K6")
    dev = means3d.device
    tan_x, focal_x, lim_x = _fov_axis(tan_fovx, width)
    tan_y, focal_y, lim_y = _fov_axis(tan_fovy, height)
    need_means, need_scales, need_rotations, need_camera = needs
    conic = d_feats is not None

    def out(shape, asked):
        return torch.empty(shape, dtype=f32, device=dev) if asked else None

    d_means = out((n, 3), need_means)
    d_scales = out((n, 3), need_scales and conic)
    d_quats = out((n, 4), need_rotations and conic)
    d_wvt, d_fpt, d_tan = (out((4, 4), need_camera),
                           out((4, 4), need_camera), out(2, need_camera))
    partials = (torch.empty(_K6_CAMERA_TERMS * _K6_MAX_BLOCKS,
                            dtype=torch.float64, device=dev)
                if need_camera else None)

    def strides(x, count):
        return x.stride() if x is not None else (0,) * count

    held = []  # the contiguous inputs, alive until the launch is queued
    ptr = _pointers(held)
    args = (ptr(means3d), ptr(scales), ptr(rotations), n,
            ptr(world_view_transform), ptr(full_proj_transform), tan_x,
            tan_y, focal_x, focal_y, lim_x, lim_y, width, height,
            scale_modifier, _data(d_feats), *strides(d_feats, 2),
            _data(d_depth), *strides(d_depth, 1), _data(d_mean2d),
            *strides(d_mean2d, 2), _data(d_means), _data(d_scales),
            _data(d_quats), _data(partials), _K6_MAX_BLOCKS, _data(d_wvt),
            _data(d_fpt), _data(d_tan))
    launch("preprocess_bwd", "segs_preprocess_backward", _K6_ARGTYPES, dev,
           args)
    preprocess_backward_cuda.launches += 1
    d_tans = [d_tan[axis] if need_camera and isinstance(tan, torch.Tensor)
              and tan.is_cuda else None
              for axis, tan in enumerate((tan_fovx, tan_fovy))]
    return d_means, d_scales, d_quats, d_wvt, d_fpt, *d_tans


preprocess_backward_cuda.launches = 0  # K6 calls (one or two kernels each)


def _camera_shapes(means3d, scales, rotations, world_view_transform,
                   full_proj_transform, tan_fovx, tan_fovy) -> list:
    """(name, tensor, shape, dtype) of the inputs K5 and K6 both read: the
    gaussians' rows, the two matrices and the device tan_fov tensors."""
    n, f32 = means3d.shape[0], torch.float32
    shapes = [("means3d", means3d, (n, 3), f32),
              ("scales", scales, (n, 3), f32),
              ("rotations", rotations, (n, 4), f32),
              ("world_view_transform", world_view_transform, (4, 4), f32),
              ("full_proj_transform", full_proj_transform, (4, 4), f32)]
    for tan, name in ((tan_fovx, "tan_fovx"), (tan_fovy, "tan_fovy")):
        if isinstance(tan, torch.Tensor) and tan.is_cuda:
            shapes.append((name, tan.reshape(-1), (1,), f32))
    return shapes


def _check_inputs(shapes, kernel: str) -> None:
    """Raise, naming the tensor, on a shape or type other than the kernel's,
    or on a tensor off the first tensor's CUDA device."""
    for name, x, shape, dtype in shapes:
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
    dev = shapes[0][1].device
    for name, x, _, _ in shapes:
        if x.device != dev or not x.is_cuda:
            raise ValueError(f"{kernel} needs every tensor on one CUDA "
                             f"device; {name} is on {x.device}")


def _pointers(held: list):
    """ptr(x): the device pointer of x made contiguous (None for None),
    the contiguous tensor appended to `held`."""
    def ptr(x):
        if x is None:
            return None
        held.append(x.detach().contiguous())
        return held[-1].data_ptr()
    return ptr


def _data(x):
    """x's device pointer as it is (strides and all), or None."""
    return None if x is None else x.data_ptr()


class _Projection(torch.autograd.Function):
    """`project` on the card: K5's full entry forward, K6 backward. The
    differentiable outputs are feats [NPAY, N], depth [N] and, with an
    offset, mean2d [2, N] (without one, mean2d is rows 0-1 of feats); the
    int32 rows, alive and kmax_truncated carry none. Saves only its
    inputs: K6 recomputes the forward's intermediates."""

    @staticmethod
    def forward(ctx, means3d, scales, rotations, opacities, colors,
                world_view_transform, full_proj_transform, tan_fovx,
                tan_fovy, mean2d_offset, valid, width, height, config,
                scale_modifier):
        for tan, name in ((tan_fovx, "tan_fovx"), (tan_fovy, "tan_fovy")):
            if (isinstance(tan, torch.Tensor) and tan.requires_grad
                    and not tan.is_cuda):
                raise ValueError(f"{name} asks a gradient on {tan.device}: "
                                 f"K6 takes tan_fov's gradient on the card")
        out = _launch_preprocess(
            means3d, scales, rotations, world_view_transform,
            full_proj_transform, width, height, tan_fovx, tan_fovy, config,
            valid, opacities, colors, mean2d_offset, scale_modifier)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*out[3:])
        tans = [t if isinstance(t, torch.Tensor) else None
                for t in (tan_fovx, tan_fovy)]
        ctx.save_for_backward(means3d, scales, rotations,
                              world_view_transform, full_proj_transform,
                              *tans)
        ctx.host_tans = (tan_fovx, tan_fovy)
        ctx.size = (width, height)
        ctx.scale_modifier = scale_modifier
        ctx.opacity_shape = opacities.shape
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_feats, d_depth, d_mean2d, *_):
        means3d, scales, rotations, wvt, fpt, tan_x, tan_y = \
            ctx.saved_tensors
        tans = [t if t is not None else host
                for t, host in zip((tan_x, tan_y), ctx.host_tans)]
        need = ctx.needs_input_grad
        grads = [None] * 15
        if d_feats is not None:
            if need[3]:
                grads[3] = d_feats[5].reshape(ctx.opacity_shape)
            if need[4]:
                grads[4] = d_feats[6:9].T
            if need[9]:
                grads[9] = d_feats[:2].T
        camera = any(need[5:9])
        if any(need[:3]) or camera:
            tracing.count("render.preprocess_bwd_kernel", 1)
            g = preprocess_backward_cuda(
                means3d, scales, rotations, wvt, fpt, *ctx.size, *tans,
                d_feats, d_depth, d_mean2d, ctx.scale_modifier,
                (need[0], need[1], need[2], camera))
            for slot, grad in zip((0, 1, 2, 5, 6, 7, 8), g):
                if need[slot]:
                    grads[slot] = grad
        return tuple(grads)


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
    blends' inputs (see `blend_inputs`). On CUDA inputs
    (`uses_preprocess_kernel`) K5 computes them and K6 their gradient, in
    one autograd.Function (K5 alone where autograd records nothing); on the
    CPU the eager autograd chain. The two agree bit for bit in the values,
    and within rounding in the gradient."""
    with tracing.span("render.project"):
        if uses_preprocess_kernel(means3d):
            tracing.count("render.preprocess_kernel", 1)
            if torch.is_grad_enabled():
                proj, feats, aux = _projection(*_Projection.apply(
                    means3d, scales, rotations, opacities, colors,
                    world_view_transform, full_proj_transform, tan_fovx,
                    tan_fovy, mean2d_offset, valid, width, height, config,
                    scale_modifier))
            else:  # no graph is recorded: K5 without the Function
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
    if uses_preprocess_kernel(means3d):
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
