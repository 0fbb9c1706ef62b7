"""Per-Gaussian projection preprocess: the front half of the tile rasterizer.

Port of segs_slam_tpu/ops/rasterizer/preprocess.py (reference:
cuda_rasterizer/forward.cu:74-256 computeCov2D/computeCov3D/preprocessCUDA,
auxiliary.h:41-57,140-166). The arithmetic is kept elementwise and in the
same order as the JAX version, so that the integer outputs (radius, tile
rects, tiles_touched) come out identical for identical f32 inputs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static rasterizer configuration; field for field the JAX package's
    RasterConfig (see there for each knob's rationale).

    tile = screen-space tile edge in pixels; compact = capacity of the
    visible-gaussian compaction; kmax = max tiles per gaussian (rect clamped
    around the centre); ksmall/nlarge = dual-rate expansion (every gaussian
    gets ksmall slots, the nlarge largest footprints get up to kmax). The
    3-tier (kmid/nmid), sel_direct and pack8 fields drive the packed eval
    binning (binning.py, blend.py:binned_blend_eval; `eval_variant` turns
    them on); packed_train lets the training blend bin through the packed
    sorts where they fit (blend.py:uses_packed_train). kanchor is not
    implemented: the eval binning rejects it.
    """

    tile: int = 16
    compact: int = 2**17
    kmax: int = 16
    chunk: int = 256
    near: float = 0.2
    alpha_min: float = 1.0 / 255.0
    alpha_clamp: float = 0.99
    transmittance_min: float = 1.0e-4
    ksmall: int = 0
    nlarge: int = 0
    kmid: int = 0
    nmid: int = 0
    kanchor: int = 0
    kgroup: int = 0
    sel_direct: bool = False
    pack8: bool = False
    packed_train: bool = False

    def __post_init__(self):
        if self.nmid:
            if not self.ksmall:
                raise ValueError("nmid > 0 requires ksmall > 0")
            if not (self.ksmall < self.kmid < self.kmax):
                raise ValueError(
                    f"need ksmall < kmid < kmax, got {self.ksmall}/"
                    f"{self.kmid}/{self.kmax}")
            if self.nlarge > self.nmid:
                raise ValueError("nlarge must be <= nmid (tier prefix)")
        elif self.kmid:
            raise ValueError("kmid > 0 requires nmid > 0")
        if self.ksmall and not self.nlarge:
            raise ValueError("ksmall > 0 requires nlarge > 0")
        if self.kanchor and (not self.kgroup or self.kanchor >= self.kgroup):
            raise ValueError("kanchor requires 0 < kanchor < kgroup")
        if self.sel_direct and not self.ksmall:
            raise ValueError("sel_direct requires the tiered expansion "
                             "(ksmall > 0)")
        if self.pack8 and not self.sel_direct:
            raise ValueError("pack8 is implemented on the sel_direct eval "
                             "path only")

    def grid(self, width: int, height: int) -> tuple[int, int]:
        tx = (width + self.tile - 1) // self.tile
        ty = (height + self.tile - 1) // self.tile
        return tx, ty

    def eval_variant(self, width: int, height: int) -> "RasterConfig":
        """The eval-path upgrade of this (training) config, as the JAX
        package chooses it: 3-tier expansion, direct-selection binning and
        byte-packed colours (sel_direct + pack8), with nmid = compact / 8 and
        nlarge = compact / 32 as floors. Returns self unchanged where the
        packed layouts do not fit: tiles other than 16 px, a grid over 63x31
        tiles, or kmax outside 6..31."""
        tx, ty = self.grid(width, height)
        if (self.tile != 16 or tx > 63 or ty > 31 or self.kmax > 31
                or self.kmax < 6):
            return self
        nmid = max(self.nmid, self.compact // 8)
        nlarge = min(nmid, max(self.nlarge if self.ksmall else 0,
                               self.compact // 32))
        return dataclasses.replace(
            self, sel_direct=True, pack8=True, packed_train=False,
            ksmall=2, kmid=self.kmax // 2, nmid=nmid, nlarge=nlarge)

    @property
    def max_instances(self) -> int:
        if self.ksmall and self.nmid:
            return (self.compact * self.ksmall
                    + self.nmid * (self.kmid - self.ksmall)
                    + self.nlarge * (self.kmax - self.kmid))
        if self.ksmall:
            return self.compact * self.ksmall + self.nlarge * (
                self.kmax - self.ksmall
            )
        return self.compact * self.kmax


class GaussianProjection(NamedTuple):
    """Per-Gaussian screen-space quantities ([N] leading axis)."""

    mean2d: torch.Tensor  # (N, 2) pixel coords
    conic: torch.Tensor  # (N, 3) inverse 2D covariance (a, b, c)
    depth: torch.Tensor  # (N,) view-space z
    radius: torch.Tensor  # (N,) int32 pixel radius, 0 = culled
    rect_min: torch.Tensor  # (N, 2) int32 tile coords (x, y)
    rect_max: torch.Tensor  # (N, 2) int32 tile coords, exclusive
    tiles_touched: torch.Tensor  # (N,) int32
    kmax_truncated: torch.Tensor  # () int32: valid gaussians shrunk to kmax


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 as XLA converts: truncation toward zero, saturating at
    the int32 range, NaN -> 0 (a bare .to(int32) is undefined out of range)."""
    x = torch.nan_to_num(x, nan=0.0).clamp(-2.0**31, 2.0**31)
    return x.to(torch.int64).clamp(-2**31, 2**31 - 1).to(torch.int32)


def _clip(x, lo, hi):
    """jnp.clip: min(max(x, lo), hi), so hi wins when lo > hi."""
    return torch.minimum(torch.maximum(x, lo), hi)


def compute_cov3d(scales: torch.Tensor, quats: torch.Tensor,
                  scale_modifier: float = 1.0) -> torch.Tensor:
    """World-space 3D covariance R diag(s^2) R^T from linear scales and
    (w, x, y, z) quaternions used as given, packed (xx, xy, xz, yy, yz, zz)."""
    s = scales * scale_modifier
    w, x, y, z = quats[..., 0], quats[..., 1], quats[..., 2], quats[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    s0, s1, s2 = s[..., 0] ** 2, s[..., 1] ** 2, s[..., 2] ** 2
    c_xx = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    c_xy = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    c_xz = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    c_yy = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    c_yz = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    c_zz = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2
    return torch.stack([c_xx, c_xy, c_xz, c_yy, c_yz, c_zz], dim=-1)


def _ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    """reference: auxiliary.h:41-45"""
    return ((v + 1.0) * size - 1.0) * 0.5


def _transform_rows(x, y, z, M):
    """(x, y, z, 1) @ M for [N] coords and a 4x4 matrix, elementwise."""
    return [x * M[0, j] + y * M[1, j] + z * M[2, j] + M[3, j]
            for j in range(4)]


def _away_from_zero(v: torch.Tensor, eps: float) -> torch.Tensor:
    """Sign-preserving clamp of |v| < eps to +-eps (guards divides for
    degenerate, masked-out gaussians)."""
    return torch.where(v.abs() < eps, torch.where(v < 0, -eps, eps), v)


def compute_cov2d(means3d, cov3d, world_view_transform, focal_x, focal_y,
                  tan_fovx, tan_fovy) -> torch.Tensor:
    """EWA 2D covariance (a, b, c) with the +0.3 low-pass filter and the
    reference's view-direction clamp (forward.cu:74-113).
    world_view_transform is W2C^T (row-vector form)."""
    x, y, z = means3d[..., 0], means3d[..., 1], means3d[..., 2]
    wvt = world_view_transform
    tx0, ty0, tz, _ = _transform_rows(x, y, z, wvt)
    tz = _away_from_zero(tz, 1e-6)

    # jnp.clip's tie gradient (0.5 to each side at a bound) comes from
    # minimum/maximum; torch.clamp would pass all of it to x
    limx = torch.as_tensor(1.3 * tan_fovx, dtype=tz.dtype, device=tz.device)
    limy = torch.as_tensor(1.3 * tan_fovy, dtype=tz.dtype, device=tz.device)
    tx = _clip(tx0 / tz, -limx, limx) * tz
    ty = _clip(ty0 / tz, -limy, limy) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z2

    w = [[wvt[j, i] for j in range(3)] for i in range(3)]  # w[i][j] = W2C[i,j]
    m00 = j00 * w[0][0] + j02 * w[2][0]
    m01 = j00 * w[0][1] + j02 * w[2][1]
    m02 = j00 * w[0][2] + j02 * w[2][2]
    m10 = j11 * w[1][0] + j12 * w[2][0]
    m11 = j11 * w[1][1] + j12 * w[2][1]
    m12 = j11 * w[1][2] + j12 * w[2][2]

    c0, c1, c2 = cov3d[..., 0], cov3d[..., 1], cov3d[..., 2]
    c3, c4, c5 = cov3d[..., 3], cov3d[..., 4], cov3d[..., 5]
    v0m0 = c0 * m00 + c1 * m01 + c2 * m02
    v1m0 = c1 * m00 + c3 * m01 + c4 * m02
    v2m0 = c2 * m00 + c4 * m01 + c5 * m02
    v0m1 = c0 * m10 + c1 * m11 + c2 * m12
    v1m1 = c1 * m10 + c3 * m11 + c4 * m12
    v2m1 = c2 * m10 + c4 * m11 + c5 * m12

    a = m00 * v0m0 + m01 * v1m0 + m02 * v2m0 + 0.3
    b = m00 * v0m1 + m01 * v1m1 + m02 * v2m1
    cc = m10 * v0m1 + m11 * v1m1 + m12 * v2m1 + 0.3
    return torch.stack([a, b, cc], dim=-1)


def preprocess_gaussians(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    world_view_transform: torch.Tensor,
    full_proj_transform: torch.Tensor,
    width: int,
    height: int,
    tan_fovx,
    tan_fovy,
    config: RasterConfig,
    valid_in: torch.Tensor | None = None,
) -> GaussianProjection:
    """Project Gaussians to screen space and compute tile footprints
    (preprocessCUDA, forward.cu:154-256, minus colour). `valid_in` masks
    padded / inactive entries of fixed-capacity buffers. tan_fovx/y may be
    Python floats or 0-d tensors, as in the JAX version."""
    focal_x = width / (2.0 * tan_fovx)
    focal_y = height / (2.0 * tan_fovy)

    mx, my, mz = means3d[..., 0], means3d[..., 1], means3d[..., 2]
    _, _, depth, _ = _transform_rows(mx, my, mz, world_view_transform)

    hx, hy, _, hw = _transform_rows(mx, my, mz, full_proj_transform)
    p_w = 1.0 / _away_from_zero(hw + 1.0e-7, 1e-6)
    mean2d = torch.stack(
        [_ndc2pix(hx * p_w, width), _ndc2pix(hy * p_w, height)], dim=-1)

    cov = compute_cov2d(means3d, cov3d, world_view_transform, focal_x,
                        focal_y, tan_fovx, tan_fovy)
    det = cov[..., 0] * cov[..., 2] - cov[..., 1] * cov[..., 1]
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    conic = torch.stack(
        [cov[..., 2] * inv_det, -cov[..., 1] * inv_det, cov[..., 0] * inv_det],
        dim=-1)

    mid = 0.5 * (cov[..., 0] + cov[..., 2])
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam_max, min=0.0)))

    valid = (depth > config.near) & (det != 0.0)
    if valid_in is not None:
        valid = valid & valid_in

    # Tile footprint (auxiliary.h:47-57 getRect).
    tx, ty = config.grid(width, height)
    px, py, r = mean2d[..., 0], mean2d[..., 1], radius_f
    tile = float(config.tile)
    rect_min_x = to_int32(torch.clamp(torch.floor((px - r) / tile), 0, tx))
    rect_min_y = to_int32(torch.clamp(torch.floor((py - r) / tile), 0, ty))
    rect_max_x = to_int32(
        torch.clamp(torch.floor((px + r + tile - 1) / tile), 0, tx))
    rect_max_y = to_int32(
        torch.clamp(torch.floor((py + r + tile - 1) / tile), 0, ty))

    # Static-shape divergence from the reference, kept from the JAX version:
    # each rect is clamped to at most kmax tiles, shrunk around the projected
    # centre. Exact whenever w * h <= kmax.
    w = rect_max_x - rect_min_x
    h = rect_max_y - rect_min_y
    over = (w * h) > config.kmax
    ratio = torch.sqrt(config.kmax / torch.clamp((w * h).float(), min=1.0))
    w2 = torch.clamp(to_int32(w.float() * ratio), min=1)
    w2 = torch.clamp(w2, max=config.kmax)
    h2 = torch.minimum(
        torch.clamp(config.kmax // torch.clamp(w2, min=1), min=1), h)
    w2 = torch.where(over, w2, w)
    h2 = torch.where(over, h2, h)
    cx_t = _clip(to_int32(px / tile), rect_min_x, rect_max_x - 1)
    cy_t = _clip(to_int32(py / tile), rect_min_y, rect_max_y - 1)
    nmin_x = _clip(cx_t - w2 // 2, rect_min_x, rect_max_x - w2)
    nmin_y = _clip(cy_t - h2 // 2, rect_min_y, rect_max_y - h2)
    rect_min_x = torch.where(over, nmin_x, rect_min_x)
    rect_min_y = torch.where(over, nmin_y, rect_min_y)
    rect_max_x = torch.where(over, nmin_x + w2, rect_max_x)
    rect_max_y = torch.where(over, nmin_y + h2, rect_max_y)

    tiles_touched = (rect_max_x - rect_min_x) * (rect_max_y - rect_min_y)
    valid = valid & (tiles_touched > 0)

    radius = to_int32(torch.where(valid, r, 0.0))
    tiles_touched = torch.where(valid, tiles_touched, 0)
    kmax_truncated = (over & valid).sum(dtype=torch.int32)

    return GaussianProjection(
        mean2d=mean2d,
        conic=conic,
        depth=depth,
        radius=radius,
        rect_min=torch.stack([rect_min_x, rect_min_y], dim=-1),
        rect_max=torch.stack([rect_max_x, rect_max_y], dim=-1),
        tiles_touched=tiles_touched,
        kmax_truncated=kmax_truncated,
    )
