"""Parity of the port's binning (compaction, flat and dual-rate expansion,
(tile, depth) sort, tile ranges) with the JAX package: every output equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from segs_slam_tpu.core import Camera
from segs_slam_tpu.core.keyframe import Keyframe
from segs_slam_tpu.ops.rasterizer import binning as jbin
from segs_slam_tpu.ops.rasterizer import preprocess as jpre
from segs_slam_tpu_torch.ops.rasterizer import binning as tbin
from segs_slam_tpu_torch.ops.rasterizer import preprocess as tpre
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

W, H = 96, 64


def _blend_inputs(n=300, seed=0, big=20):
    """Per-gaussian (feats [9, N], aux) as numpy, from the JAX preprocess of
    a random scene with `big` large-footprint gaussians."""
    rng = np.random.default_rng(seed)
    cam = Camera(camera_id=0, width=W, height=H, fx=80.0, fy=80.0,
                 cx=W / 2, cy=H / 2)
    kf = Keyframe(kf_id=0, camera=cam, quat=[1, 0, 0, 0], trans=[0, 0, 0])
    means = rng.uniform([-1.5, -1.0, 2.0], [1.5, 1.0, 6.0], (n, 3))
    scales = np.exp(rng.uniform(-3.5, -2.5, (n, 3)))
    scales[:big] = np.exp(rng.uniform(-1.8, -1.2, (big, 3)))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
    cov = jpre.compute_cov3d(f32(scales), f32(quats))
    proj = jpre.preprocess_gaussians(
        f32(means), cov, f32(kf.world_view_transform),
        f32(kf.full_proj_transform), W, H, cam.tan_fovx, cam.tan_fovy,
        jpre.RasterConfig(tile=16, compact=512, kmax=16, chunk=64))
    m2, con = np.asarray(proj.mean2d), np.asarray(proj.conic)
    feats = np.stack([m2[:, 0], m2[:, 1], con[:, 0], con[:, 1], con[:, 2],
                      rng.uniform(0.05, 0.95, n), *rng.uniform(0, 1, (3, n))]
                     ).astype(np.float32)
    rmin, rmax = np.asarray(proj.rect_min), np.asarray(proj.rect_max)
    aux = {"rect_min_x": rmin[:, 0], "rect_min_y": rmin[:, 1],
           "rect_w": rmax[:, 0] - rmin[:, 0],
           "touched": np.asarray(proj.tiles_touched),
           "depth": np.asarray(proj.depth),
           "alive": np.asarray(proj.radius) > 0}
    return feats, aux


def _run_both(feats, aux, **cfg_kw):
    cfg_j = jpre.RasterConfig(tile=16, chunk=64, **cfg_kw)
    cfg_t = tpre.RasterConfig(tile=16, chunk=64, **cfg_kw)
    tx, ty = cfg_t.grid(W, H)
    cg_j = jbin.compact_gaussians(
        tuple(jnp.asarray(f) for f in feats),
        {k: jnp.asarray(v) for k, v in aux.items()}, cfg_j)
    cg_t = tbin.compact_gaussians(
        torch.as_tensor(feats),
        {k: torch.as_tensor(v) for k, v in aux.items()}, cfg_t)
    return (cg_j, jbin.expand_and_sort(cg_j, tx, ty, cfg_j),
            cg_t, tbin.expand_and_sort(cg_t, tx, ty, cfg_t))


def _eq(a, b, msg):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, msg
    np.testing.assert_array_equal(a, b, err_msg=msg)


@pytest.mark.parametrize("case,cfg_kw", [
    ("flat", dict(compact=512, kmax=16)),
    ("dual_rate", dict(compact=512, kmax=16, ksmall=4, nlarge=64)),
    ("compact_overflow", dict(compact=64, kmax=8)),
    ("nlarge_overflow", dict(compact=512, kmax=16, ksmall=2, nlarge=4)),
])
def test_binning_matches_jax(case, cfg_kw):
    feats, aux = _blend_inputs()
    cg_j, b_j, cg_t, b_t = _run_both(feats, aux, **cfg_kw)

    _eq(cg_t.feats.numpy(), np.stack([np.asarray(f) for f in cg_j.feats]),
        "compact feats")
    for name in ("rect_min_x", "rect_min_y", "rect_w", "touched", "depth",
                 "orig_id", "valid", "num_valid"):
        _eq(getattr(cg_t, name).numpy(), getattr(cg_j, name), name)

    _eq(b_t.feats_sorted.numpy(),
        np.stack([np.asarray(f) for f in b_j.feats_sorted]), "feats_sorted")
    for name in ("gid_sorted", "tile_start", "tile_stop", "num_instances",
                 "num_large"):
        _eq(getattr(b_t, name).numpy(), getattr(b_j, name), name)
    assert b_t.tile_start.dtype == torch.int32

    # the regime each case is meant to exercise
    n_alive = int(aux["alive"].sum())
    if case == "compact_overflow":
        assert n_alive > cfg_kw["compact"] == int(cg_t.valid.sum())
    if case == "nlarge_overflow":
        assert int(b_t.num_large) > cfg_kw["nlarge"]
    if case == "dual_rate":
        assert 0 < int(b_t.num_large) <= cfg_kw["nlarge"]


def test_priority_compaction_keeps_brightest():
    """Over capacity the faintest gaussians are dropped (as
    tests/test_rasterizer.py pins for the JAX package); non-finite opacity
    counts as dead."""
    n, cap = 64, 16
    rng = np.random.default_rng(0)
    opac = rng.uniform(0.01, 0.2, n).astype(np.float32)
    bright = [5, 40, 63]
    opac[bright] = [0.9, 0.95, 0.99]
    opac[7] = np.nan
    feats = np.concatenate([rng.uniform(size=(5, n)), opac[None],
                            rng.uniform(size=(3, n))]).astype(np.float32)
    aux = {"rect_min_x": np.zeros(n, np.int32),
           "rect_min_y": np.zeros(n, np.int32),
           "rect_w": np.ones(n, np.int32), "touched": np.ones(n, np.int32),
           "depth": rng.uniform(1, 5, n).astype(np.float32),
           "alive": np.ones(n, bool)}
    cg_j, _, cg_t, _ = _run_both(feats, aux, compact=cap, kmax=4)
    kept = set(cg_t.orig_id[cg_t.valid].tolist())
    assert set(bright) <= kept and 7 not in kept
    assert kept == set(np.argsort(-np.nan_to_num(opac, nan=-1))[:cap].tolist())
    assert int(cg_t.num_valid) == n
    _eq(cg_t.orig_id.numpy(), cg_j.orig_id, "orig_id")


def test_depth_order_key_matches_lax_sort():
    """Sentinel-tile slots carry arbitrary depths (negative, -0, inf, NaN):
    the int64 key orders them exactly as lax.sort's (tile, depth) order."""
    rng = np.random.default_rng(1)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-30,
                         -1e-30, 3.0, -3.0], np.float32)
    depth = np.concatenate([specials, specials,
                            rng.normal(0, 5, 200).astype(np.float32)])
    tile = rng.integers(0, 4, depth.shape[0]).astype(np.int32)
    idx = np.arange(depth.shape[0], dtype=np.int32)
    ref = np.asarray(lax.sort((jnp.asarray(tile), jnp.asarray(depth),
                               jnp.asarray(idx)), num_keys=2,
                              is_stable=True)[2])
    key = ((torch.as_tensor(tile).to(torch.int64) << 32)
           | tbin.depth_order_key(torch.as_tensor(depth)))
    _eq(torch.sort(key, stable=True).indices.numpy(), ref, "order")
