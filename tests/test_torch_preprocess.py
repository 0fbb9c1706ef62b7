"""Parity of the port's rasterizer preprocess with the JAX package: floats at
1e-5, integer footprints (radius, rects, tiles_touched, kmax_truncated)
equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segs_slam_tpu.core import Camera
from segs_slam_tpu.core.keyframe import Keyframe
from segs_slam_tpu.ops.rasterizer import preprocess as jpre
from segs_slam_tpu.ops.rasterizer import visible_filter as j_visible_filter
from segs_slam_tpu_torch.ops.rasterizer import preprocess as tpre
from segs_slam_tpu_torch.ops.rasterizer import visible_filter
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

W, H = 48, 32


def _scene(n=200, seed=0, big=0):
    rng = np.random.default_rng(seed)
    cam = Camera(camera_id=0, width=W, height=H, fx=40.0, fy=40.0,
                 cx=W / 2, cy=H / 2)
    kf = Keyframe(kf_id=0, camera=cam, quat=[0.99, 0.05, -0.08, 0.02],
                  trans=[0.1, -0.2, 0.3])
    means = rng.uniform([-2.0, -1.5, -1.0], [2.0, 1.5, 6.0], (n, 3))
    scales = np.exp(rng.uniform(-3.2, -1.8, (n, 3)))
    scales[:big] = np.exp(rng.uniform(-1.0, -0.5, (big, 3)))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    valid = rng.uniform(size=n) > 0.2
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return kf, f32(means), f32(scales), f32(quats), valid


def test_raster_config_checks_and_sizes():
    good = [dict(), dict(compact=256, kmax=8, ksmall=4, nlarge=64),
            dict(compact=512, kmax=16, ksmall=2, kmid=8, nmid=64, nlarge=32,
                 sel_direct=True, pack8=True),
            dict(kanchor=6, kgroup=10), dict(tile=8)]
    for kw in good:
        a, b = tpre.RasterConfig(**kw), jpre.RasterConfig(**kw)
        assert a.max_instances == b.max_instances, kw
        assert a.grid(W + 5, H) == b.grid(W + 5, H), kw
    bad = [dict(nmid=8), dict(ksmall=2, kmid=8, kmax=8, nmid=8, nlarge=4),
           dict(ksmall=2, kmid=4, kmax=8, nmid=8, nlarge=16), dict(kmid=4),
           dict(ksmall=4), dict(kanchor=10, kgroup=10),
           dict(sel_direct=True), dict(pack8=True)]
    for kw in bad:
        with pytest.raises(ValueError):
            jpre.RasterConfig(**kw)
        with pytest.raises(ValueError):
            tpre.RasterConfig(**kw)


def test_cov3d_cov2d_match_jax():
    kf, means, scales, quats, _ = _scene(seed=1)
    cam = kf.camera
    cov_j = jpre.compute_cov3d(jnp.asarray(scales), jnp.asarray(quats), 1.3)
    cov_t = tpre.compute_cov3d(torch.as_tensor(scales),
                               torch.as_tensor(quats), 1.3)
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), rtol=1e-5,
                               atol=1e-7)
    focal = (cam.fx, cam.fy, cam.tan_fovx, cam.tan_fovy)
    c2_j = jpre.compute_cov2d(jnp.asarray(means), cov_j,
                              jnp.asarray(kf.world_view_transform), *focal)
    c2_t = tpre.compute_cov2d(torch.as_tensor(means),
                              torch.tensor(np.asarray(cov_j)),
                              torch.as_tensor(kf.world_view_transform),
                              *focal)
    np.testing.assert_allclose(c2_t.numpy(), np.asarray(c2_j), rtol=1e-5,
                               atol=1e-5)


def _compare_projection(pt, pj):
    for name in ("mean2d", "conic", "depth"):
        np.testing.assert_allclose(getattr(pt, name).numpy(),
                                   np.asarray(getattr(pj, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    for name in ("radius", "rect_min", "rect_max", "tiles_touched",
                 "kmax_truncated"):
        a, b = getattr(pt, name).numpy(), np.asarray(getattr(pj, name))
        assert a.dtype == b.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("kmax,big,tensor_fov,masked", [
    (64, 0, False, False),   # no truncation
    (4, 20, False, True),    # kmax rect clamp active, padded buffer mask
    (4, 40, True, True),     # tan_fov as f32 0-d arrays (the render path)
])
def test_preprocess_matches_jax(kmax, big, tensor_fov, masked):
    kf, means, scales, quats, valid = _scene(seed=kmax, big=big)
    cov = np.asarray(jpre.compute_cov3d(jnp.asarray(scales),
                                        jnp.asarray(quats)))
    cfg_j = jpre.RasterConfig(tile=16, compact=256, kmax=kmax, chunk=64)
    cfg_t = tpre.RasterConfig(tile=16, compact=256, kmax=kmax, chunk=64)
    tan = (kf.camera.tan_fovx, kf.camera.tan_fovy)
    if tensor_fov:
        tan_j = tuple(jnp.asarray(np.float32(x)) for x in tan)
        tan_t = tuple(torch.tensor(np.float32(x)) for x in tan)
    else:
        tan_j = tan_t = tan
    pj = jpre.preprocess_gaussians(
        jnp.asarray(means), jnp.asarray(cov),
        jnp.asarray(kf.world_view_transform),
        jnp.asarray(kf.full_proj_transform), W, H, *tan_j, cfg_j,
        valid_in=jnp.asarray(valid) if masked else None)
    pt = tpre.preprocess_gaussians(
        torch.as_tensor(means), torch.as_tensor(cov),
        torch.as_tensor(kf.world_view_transform),
        torch.as_tensor(kf.full_proj_transform), W, H, *tan_t, cfg_t,
        valid_in=torch.as_tensor(valid) if masked else None)
    _compare_projection(pt, pj)
    assert int(pt.radius.gt(0).sum()) > 20  # the scene is not all culled
    if big:
        assert int(pt.kmax_truncated) > 0


def test_to_int32_matches_xla_conversion():
    x = np.array([0.5, -0.5, -1.7, 2.9, 3e9, -3e9, np.inf, -np.inf, np.nan],
                 np.float32)
    ref = np.asarray(jnp.asarray(x).astype(jnp.int32))
    np.testing.assert_array_equal(tpre.to_int32(torch.as_tensor(x)).numpy(),
                                  ref)


def test_visible_filter_matches_jax():
    kf, means, scales, quats, valid = _scene(seed=5)
    means[:10, 2] = -1.0
    common = (W, H, kf.camera.tan_fovx, kf.camera.tan_fovy)
    ref = j_visible_filter(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats),
        jnp.asarray(kf.world_view_transform),
        jnp.asarray(kf.full_proj_transform), *common,
        config=jpre.RasterConfig(), valid=jnp.asarray(valid))
    ours = visible_filter(
        torch.as_tensor(means), torch.as_tensor(scales),
        torch.as_tensor(quats), torch.as_tensor(kf.world_view_transform),
        torch.as_tensor(kf.full_proj_transform), *common,
        config=tpre.RasterConfig(), valid=torch.as_tensor(valid))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert not ours[:10].any() and ours.any()
