"""Sensor frontends: sparse->dense geometry harvesting per sensor type.

Numpy re-designs of the reference's per-sensor densification kernels
(reference: src/stereo_vision.cu / GaussianMapper::increasePcdByKeyframe-
InactiveGeoDensify, src/gaussian_mapper.cpp:1544-1731):

  * RGB-D: pinhole depth back-projection (reproject_depths_pinhole,
    src/stereo_vision.cu:39-61) — a couple of vectorized numpy ops.
  * Monocular: keypoint-neighborhood depth guessing (the O(N^2)
    neighbor-search kernel, src/stereo_vision.cu:63-133) — vectorized
    pairwise distances.
  * Stereo: block-matching disparity (stands in for the reference's
    cv::cuda::StereoSGM, src/gaussian_mapper.cpp:93-95, 1591-1650).

These run on the host mapper thread (they feed the anchor-insert path, which
is host-side anyway); numpy is plenty at keyframe rate.

Copy of segs_slam_tpu/slam/frontends.py.
"""

from __future__ import annotations

import numpy as np

from segs_slam_tpu_torch.core.camera import Camera


def _c2w(quat: np.ndarray, trans: np.ndarray) -> np.ndarray:
    w, x, y, z = quat
    R = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    Rt = np.eye(4)
    Rt[:3, :3] = R
    Rt[:3, 3] = trans
    return np.linalg.inv(Rt)


def backproject_depth(
    depth: np.ndarray,
    camera: Camera,
    quat: np.ndarray,
    trans: np.ndarray,
    min_depth: float = 1e-10,
    max_depth: float = 40.0,
    stride: int = 4,
) -> np.ndarray:
    """Depth map -> world points (reference: reproject_depths_pinhole).

    `stride` subsamples the depth image (the voxel filter in increasePcd
    collapses dense duplicates anyway; reference feeds every pixel)."""
    h, w = depth.shape
    d = depth[::stride, ::stride]
    ys, xs = np.mgrid[0:h:stride, 0:w:stride]
    valid = (d > min_depth) & (d < max_depth) & np.isfinite(d)
    z = d[valid]
    u = xs[valid]
    v = ys[valid]
    x = (u - camera.cx) / camera.fx * z
    y = (v - camera.cy) / camera.fy * z
    cam_pts = np.stack([x, y, z], axis=1)
    C2W = _c2w(np.asarray(quat, float), np.asarray(trans, float))
    return (cam_pts @ C2W[:3, :3].T + C2W[:3, 3]).astype(np.float32)


def mono_neighborhood_densify(
    keypoint_pixels: np.ndarray,  # (n, 2) undistorted pixels
    keypoint_points: np.ndarray | None,  # (n, 3) camera-local 3D or nan rows
    camera: Camera,
    quat: np.ndarray,
    trans: np.ndarray,
    max_pixel_dist: float = 15.0,
) -> np.ndarray:
    """Monocular inactive-geometry densification: keypoints without depth
    borrow the depth of their nearest pixel-space neighbor that has one
    (reference: monocularPinholeInactiveGeoDensifyBySearchingNeighborhood-
    Keypoints, src/stereo_vision.cu:63-133)."""
    if keypoint_points is None or len(keypoint_pixels) == 0:
        return np.zeros((0, 3), np.float32)
    pts = np.asarray(keypoint_points, float)
    px = np.asarray(keypoint_pixels, float)
    has_depth = np.isfinite(pts[:, 2]) & (pts[:, 2] > 0)
    if not has_depth.any() or has_depth.all():
        known = pts[has_depth]
    else:
        unknown_px = px[~has_depth]
        known_px = px[has_depth]
        known_z = pts[has_depth][:, 2]
        # pairwise pixel distances (n_unknown x n_known)
        d2 = ((unknown_px[:, None, :] - known_px[None, :, :]) ** 2).sum(-1)
        nn = np.argmin(d2, axis=1)
        ok = d2[np.arange(len(nn)), nn] <= max_pixel_dist**2
        z = known_z[nn[ok]]
        u, v = unknown_px[ok, 0], unknown_px[ok, 1]
        guessed = np.stack(
            [(u - camera.cx) / camera.fx * z, (v - camera.cy) / camera.fy * z, z],
            axis=1,
        )
        known = np.concatenate([pts[has_depth], guessed], axis=0)
    C2W = _c2w(np.asarray(quat, float), np.asarray(trans, float))
    return (known @ C2W[:3, :3].T + C2W[:3, 3]).astype(np.float32)


def _sad_cost_volume(left, right, ys, xs, d_range, hb):
    """SAD cost volumes over the strided (ys, xs) grid for every disparity.

    Returns (cost_L, cost_R): cost_L[i, j, k] is the window SAD for LEFT
    pixel (ys[i], xs[j]) at disparity d_range[k] (right match at x - d);
    cost_R is the same window indexed by RIGHT pixel (ys[i], xs[j]) (left
    match at x + d). Both come from the same per-d difference image."""
    ny, nx, nd = len(ys), len(xs), len(d_range)
    cost_l = np.full((ny, nx, nd), np.inf, np.float32)
    cost_r = np.full((ny, nx, nd), np.inf, np.float32)
    w = left.shape[1]
    yy = ys[:, None]
    for k, d in enumerate(d_range):
        if d <= 0 or d >= w - 2 * hb:
            continue
        # diff[y, x_r] = |left[y, x_r + d] - right[y, x_r]| (right-indexed)
        diff = np.abs(left[:, d:] - right[:, :-d])
        ii = diff.cumsum(0).cumsum(1)

        def box(y0, y1, x0, x1):
            return ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]

        wd = diff.shape[1]
        # left-indexed: window center x_r = x_l - d
        xxl = xs[None, :] - d
        okl = (xxl - hb >= 0) & (xxl + hb < wd)
        xc = np.clip(xxl, hb, wd - hb - 1)
        sad = box(yy - hb, yy + hb, xc - hb, xc + hb)
        cost_l[:, :, k] = np.where(okl, sad, np.inf)
        # right-indexed: window center x_r = x
        xxr = xs[None, :]
        okr = (xxr - hb >= 0) & (xxr + hb < wd)
        xc = np.clip(xxr, hb, wd - hb - 1)
        sad = box(yy - hb, yy + hb, xc - hb, xc + hb)
        cost_r[:, :, k] = np.where(okr, sad, np.inf)
    return cost_l, cost_r


def _sgm_aggregate(cost: np.ndarray, p1: float, p2: float) -> np.ndarray:
    """Semi-global cost aggregation along +-x and +-y on the strided grid
    (the reference delegates to cv::cuda::StereoSGM,
    src/gaussian_mapper.cpp:93-95; this is the classic Hirschmuller
    recursion restricted to 4 paths)."""
    big = 1e6
    c = np.where(np.isfinite(cost), cost, big).astype(np.float32)
    ny, nx, nd = c.shape
    total = np.zeros_like(c)

    def sweep(axis: int, reverse: bool) -> np.ndarray:
        L = np.empty_like(c)
        n = c.shape[axis]
        order = range(n - 1, -1, -1) if reverse else range(n)
        prev = None
        for i in order:
            sl = (slice(None), i) if axis == 1 else (i,)
            cur = c[sl]  # (other_dim, nd)
            if prev is None:
                L[sl] = cur
            else:
                m = prev.min(axis=-1, keepdims=True)
                lo = np.minimum(
                    np.roll(prev, 1, axis=-1), np.roll(prev, -1, axis=-1)
                )
                lo[..., 0] = prev[..., 1] if nd > 1 else prev[..., 0]
                lo[..., -1] = prev[..., -2] if nd > 1 else prev[..., -1]
                L[sl] = cur + np.minimum(
                    np.minimum(prev, lo + p1), m + p2
                ) - m
            prev = L[sl]
        return L

    for axis in (0, 1):
        for reverse in (False, True):
            total += sweep(axis, reverse)
    return total


def stereo_block_matching(
    left: np.ndarray,  # (h, w) grayscale [0, 1]
    right: np.ndarray,
    min_disparity: int = 2,
    num_disparities: int = 96,
    block: int = 7,
    stride: int = 4,
    uniqueness: float = 0.95,
    lr_max_diff: float = 1.5,
    sgm_p1: float = 0.03,
    sgm_p2: float = 0.3,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Strided semi-global stereo matching with subpixel refinement.

    Stand-in for the reference's cv::cuda::StereoSGM
    (src/gaussian_mapper.cpp:93-95): SAD cost volume -> 4-path SGM
    aggregation -> winner-take-all with a uniqueness ratio test ->
    left-right consistency check -> parabola subpixel fit. Returns
    (disparity, ys, xs) over the strided grid; 0 = invalid. Host numpy at
    keyframe rate.
    """
    h, w = left.shape
    hb = block // 2
    npix = block * block
    ys = np.arange(hb, h - hb, stride)
    xs = np.arange(hb, w - hb, stride)
    d_range = np.arange(min_disparity, min_disparity + num_disparities)
    cost_l, cost_r = _sad_cost_volume(left, right, ys, xs, d_range, hb)

    agg_l = _sgm_aggregate(cost_l, p1=sgm_p1 * npix, p2=sgm_p2 * npix)
    agg_r = _sgm_aggregate(cost_r, p1=sgm_p1 * npix, p2=sgm_p2 * npix)

    best_k = np.argmin(agg_l, axis=-1)
    iy, ix = np.indices(best_k.shape)
    best_c = agg_l[iy, ix, best_k]
    valid = np.isfinite(cost_l[iy, ix, best_k]) & (best_c < 1e5)

    # uniqueness: best must beat every candidate further than 1 step away
    # by the ratio (cv::StereoSGBM semantics)
    masked = agg_l.copy()
    nd = len(d_range)
    for off in (-1, 0, 1):
        kk = np.clip(best_k + off, 0, nd - 1)
        masked[iy, ix, kk] = np.inf
    second = masked.min(axis=-1)
    valid &= best_c <= uniqueness * second

    # left-right consistency: the right image's winner at x - d must agree
    d_best = d_range[best_k].astype(np.float32)
    best_kr = np.argmin(agg_r, axis=-1)
    d_right = d_range[best_kr].astype(np.float32)
    xr = xs[None, :] - d_best  # matched right pixel x
    j_r = np.clip(np.round((xr - xs[0]) / stride).astype(int), 0, len(xs) - 1)
    d_r_at = d_right[iy, j_r]
    valid &= np.abs(d_best - d_r_at) <= max(lr_max_diff, stride / 2 + 0.51)

    # parabola subpixel fit on the aggregated cost
    k0 = np.clip(best_k, 1, nd - 2)
    cm = agg_l[iy, ix, k0 - 1]
    cc = agg_l[iy, ix, k0]
    cp = agg_l[iy, ix, k0 + 1]
    denom = cm - 2 * cc + cp
    delta = np.where(np.abs(denom) > 1e-9, 0.5 * (cm - cp) / np.where(
        np.abs(denom) > 1e-9, denom, 1.0), 0.0)
    delta = np.clip(delta, -0.5, 0.5)
    disp = np.where(valid, d_best + np.where(best_k == k0, delta, 0.0), 0.0)
    # interior disparities only (clamped endpoints are unreliable)
    disp = np.where(
        (best_k > 0) & (best_k < nd - 1), disp, 0.0
    ).astype(np.float32)
    return disp, ys, xs


def stereo_densify(
    left: np.ndarray,
    right: np.ndarray,
    camera: Camera,
    baseline: float,
    quat: np.ndarray,
    trans: np.ndarray,
    min_disparity: int = 2,
    num_disparities: int = 96,
    max_depth: float = 40.0,
) -> np.ndarray:
    """Stereo inactive-geo densify: disparity -> depth -> world points
    (reference: src/gaussian_mapper.cpp:1591-1650 via reprojectImageTo3D)."""
    disp, ys, xs = stereo_block_matching(
        left, right, min_disparity, num_disparities
    )
    valid = disp > 0
    z = camera.fx * baseline / np.maximum(disp[valid], 1e-6)
    ok = (z > 0) & (z < max_depth)
    u = np.broadcast_to(xs[None, :], disp.shape)[valid][ok].astype(float)
    v = np.broadcast_to(ys[:, None], disp.shape)[valid][ok].astype(float)
    z = z[ok]
    cam_pts = np.stack(
        [(u - camera.cx) / camera.fx * z, (v - camera.cy) / camera.fy * z, z],
        axis=1,
    )
    C2W = _c2w(np.asarray(quat, float), np.asarray(trans, float))
    return (cam_pts @ C2W[:3, :3].T + C2W[:3, 3]).astype(np.float32)
