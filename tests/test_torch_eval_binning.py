"""Parity of the port's packed eval binning with the JAX package: the packed
columns (f16 layout and pack8), the compaction, the 1-, 2- and 3-tier
expansion, the direct selection, tile ranges and counts must equal JAX's bit
for bit; and RasterConfig.eval_variant field for field."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segs_slam_tpu.core import Camera
from segs_slam_tpu.core.keyframe import Keyframe
from segs_slam_tpu.ops.rasterizer import binning as jbin
from segs_slam_tpu.ops.rasterizer import preprocess as jpre
from segs_slam_tpu_torch.ops.rasterizer import binning as tbin
from segs_slam_tpu_torch.ops.rasterizer import preprocess as tpre

W, H = 96, 64


def _blend_inputs(n=300, seed=0, big=40):
    """Per-gaussian (feats [9, N], aux) as numpy, from the JAX preprocess of
    a random scene with `big` large-footprint gaussians, some of them dead
    (behind the camera) and some with subnormal-range conic entries."""
    rng = np.random.default_rng(seed)
    cam = Camera(camera_id=0, width=W, height=H, fx=80.0, fy=80.0,
                 cx=W / 2, cy=H / 2)
    kf = Keyframe(kf_id=0, camera=cam, quat=[1, 0, 0, 0], trans=[0, 0, 0])
    means = rng.uniform([-1.5, -1.0, 2.0], [1.5, 1.0, 6.0], (n, 3))
    means[:10, 2] = -1.0  # behind the camera: dead
    scales = np.exp(rng.uniform(-3.5, -2.5, (n, 3)))
    scales[10:10 + big] = np.exp(rng.uniform(-1.8, -1.0, (big, 3)))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
    cov = jpre.compute_cov3d(f32(scales), f32(quats))
    proj = jpre.preprocess_gaussians(
        f32(means), cov, f32(kf.world_view_transform),
        f32(kf.full_proj_transform), W, H, cam.tan_fovx, cam.tan_fovy,
        jpre.RasterConfig(tile=16, compact=512, kmax=16, chunk=64))
    m2, con = np.asarray(proj.mean2d), np.asarray(proj.conic)
    con = con.copy()
    con[20:30, 1] = rng.uniform(-3e-6, 3e-6, 10)  # f16 subnormals
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


def _both(feats, aux):
    return ((tuple(jnp.asarray(f) for f in feats),
             {k: jnp.asarray(v) for k, v in aux.items()}),
            (torch.tensor(feats), {k: torch.tensor(v) for k, v in aux.items()}))


def _configs(**kw):
    return (jpre.RasterConfig(tile=16, chunk=64, **kw),
            tpre.RasterConfig(tile=16, chunk=64, **kw))


def _u32(x):
    """A JAX u32 array (or int array) as int64 numpy."""
    return np.asarray(x).astype(np.int64)


def _eq(ours, ref, msg):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (msg, ours.shape, ref.shape)
    if ref.dtype.kind in "iub":
        ref = ref.astype(np.int64)
        ours = ours.astype(np.int64)
    np.testing.assert_array_equal(ours, ref, err_msg=msg)


@pytest.mark.parametrize("pack8", [False, True])
def test_pack_eval_cols_matches_jax(pack8):
    feats, aux = _blend_inputs()
    (jf, ja), (tf, ta) = _both(feats, aux)
    kw = dict(compact=512, kmax=16, ksmall=2, nlarge=64)
    if pack8:
        kw.update(sel_direct=True, pack8=True)
    cj, ct = _configs(**kw)
    pays_j, dmeta_j, ok_j, opq_j, nv_j = jbin._pack_eval_cols(jf, ja, cj)
    pays_t, dmeta_t, ok_t, opq_t, nv_t = tbin._pack_eval_cols(tf, ta, ct)
    assert pays_t.shape[0] == len(pays_j) == (4 if pack8 else 5)
    for i, col in enumerate(pays_j):
        _eq(pays_t[i], _u32(col), f"payload column {i}")
    _eq(dmeta_t, _u32(dmeta_j), "dmeta")
    _eq(ok_t, ok_j, "alive_ok")
    _eq(opq_t[ok_t], _u32(opq_j)[np.asarray(ok_j)], "opac_q")
    assert int(nv_t) == int(nv_j) < feats.shape[1]  # some rows are dead


def test_f16_helpers_match_jax():
    """f32 -> f16 rounding (ties, subnormals, overflow, signed zero), the
    unpack and the depth key, bit for bit."""
    rng = np.random.default_rng(1)
    vals = np.concatenate([
        rng.uniform(-300, 300, 200), rng.uniform(-1e-6, 1e-6, 50),
        [0.0, -0.0, 6.1e-5, 5.96e-8, 2.98e-8, 65504.0, 65520.0, 1e6, -1e6,
         1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11]]).astype(np.float32)
    other = rng.permutation(vals)
    ref = _u32(jbin._pack2f16(jnp.asarray(vals), jnp.asarray(other)))
    ours = tbin._pack2f16(torch.as_tensor(vals), torch.as_tensor(other))
    _eq(ours, ref, "pack2f16")
    for a, b in zip(tbin._unpack2f16(ours),
                    jbin._unpack2f16(jnp.asarray(ref.astype(np.uint32)))):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      np.asarray(b).view(np.int32))
    depth = rng.uniform(0.2, 80.0, 300).astype(np.float32)
    _eq(tbin._depth_key(torch.as_tensor(depth)),
        _u32(jbin._depth_key(jnp.asarray(depth))), "depth key")
    big = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1])
    assert tbin.as_u32_bits(big).tolist() == [0, 1, 2**31 - 1, -2**31, -1]


CASES = [
    ("flat", dict(compact=512, kmax=16)),
    ("dual_rate", dict(compact=512, kmax=16, ksmall=4, nlarge=64)),
    ("three_tier", dict(compact=512, kmax=16, ksmall=2, kmid=8, nmid=128,
                        nlarge=32)),
    ("compact_overflow", dict(compact=64, kmax=8, ksmall=2, kmid=4, nmid=16,
                              nlarge=8)),
    ("tier_overflow", dict(compact=512, kmax=16, ksmall=2, kmid=4, nmid=8,
                           nlarge=4)),
]


@pytest.mark.parametrize("case,kw", CASES)
def test_compact_and_expand_packed_match_jax(case, kw):
    feats, aux = _blend_inputs()
    (jf, ja), (tf, ta) = _both(feats, aux)
    cj, ct = _configs(**kw)
    tx, ty = ct.grid(W, H)
    pc_j = jbin.compact_gaussians_packed(jf, ja, cj)
    pc_t = tbin.compact_gaussians_packed(tf, ta, ct)
    for i, name in enumerate(("p_xy", "p_cab", "p_cco", "p_rg", "p_b")):
        _eq(pc_t.cols[i], _u32(getattr(pc_j, name)), name)
    _eq(pc_t.dmeta, _u32(pc_j.dmeta), "dmeta")
    _eq(pc_t.valid, pc_j.valid, "valid")
    assert int(pc_t.num_valid) == int(pc_j.num_valid)

    for packed in (True, False):
        ref = jbin.expand_and_sort_packed(pc_j, tx, ty, cj,
                                          return_packed=packed)
        ours = tbin.expand_and_sort_packed(pc_t, tx, ty, ct,
                                           return_packed=packed)
        if packed:
            assert ours[0].shape == (5, ct.max_instances)
            for i, col in enumerate(ref[0]):
                _eq(ours[0][i], _u32(col), f"sorted column {i}")
        else:
            _eq(ours[0], np.stack([np.asarray(f) for f in ref[0]]),
                "unpacked feats")
        for i, name in ((1, "tile_start"), (2, "tile_stop"),
                        (3, "num_instances"), (4, "num_large")):
            _eq(ours[i], ref[i], name)
        assert ours[1].dtype == torch.int32 and ours[3].dtype == torch.int32

    n_alive = int(aux["alive"].sum())
    if case == "compact_overflow":
        assert n_alive > kw["compact"] == int(pc_t.valid.sum())
    if case == "tier_overflow":
        assert int(ours[4]) > kw["nmid"]


# compact <= N: JAX's bin_eval_direct cannot pad (test_direct_pads_small_
# scenes)
DIRECT = [
    ("f16_dual", dict(compact=256, kmax=16, ksmall=2, nlarge=64)),
    ("f16_three_tier", dict(compact=256, kmax=16, ksmall=2, kmid=8, nmid=128,
                            nlarge=32)),
    ("pack8_three_tier", dict(compact=256, kmax=16, ksmall=2, kmid=8,
                              nmid=128, nlarge=32, pack8=True)),
    ("pack8_overflow", dict(compact=64, kmax=8, ksmall=2, kmid=4, nmid=16,
                            nlarge=8, pack8=True)),
]


@pytest.mark.parametrize("case,kw", DIRECT)
def test_bin_eval_direct_matches_jax(case, kw):
    feats, aux = _blend_inputs(seed=2)
    (jf, ja), (tf, ta) = _both(feats, aux)
    cj, ct = _configs(sel_direct=True, **kw)
    tx, ty = ct.grid(W, H)
    for packed in (True, False) if not ct.pack8 else (True,):
        ref = jbin.bin_eval_direct(jf, ja, tx, ty, cj, return_packed=packed)
        ours = tbin.bin_eval_direct(tf, ta, tx, ty, ct, return_packed=packed)
        if packed:
            assert len(ref[0]) == ours[0].shape[0] == (4 if ct.pack8 else 5)
            for i, col in enumerate(ref[0]):
                _eq(ours[0][i], _u32(col), f"sorted column {i}")
        else:
            _eq(ours[0], np.stack([np.asarray(f) for f in ref[0]]),
                "unpacked feats")
        for i, name in ((1, "tile_start"), (2, "tile_stop"),
                        (3, "num_instances"), (4, "num_valid")):
            _eq(ours[i], ref[i], name)
    if case == "pack8_overflow":
        assert int(ours[4]) > kw["compact"]
    else:
        assert 0 < int(ours[3]) and int(ours[2][-1]) == int(ours[3])
    if ct.pack8:
        with pytest.raises(ValueError, match="kernel"):
            tbin.bin_eval_direct(tf, ta, tx, ty, ct, return_packed=False)


def test_direct_pads_small_scenes():
    """Fewer raw rows than the compaction capacity. JAX's bin_eval_direct
    fails there (jnp.pad rejects its 0xFFFFFFFF pad value), so the port is
    held to JAX on the rows padded beforehand with dead zero rows: the same
    tile ranges and the same instances in every range (the sentinel tail
    differs, as the padded rows' depth keys do)."""
    feats, aux = _blend_inputs(n=40, big=6)
    nc = 64
    (jf, ja), (tf, ta) = _both(feats, aux)
    cj, ct = _configs(compact=nc, kmax=8, ksmall=2, kmid=4, nmid=16,
                      nlarge=8, sel_direct=True, pack8=True)
    tx, ty = ct.grid(W, H)
    with pytest.raises(OverflowError):
        jbin.bin_eval_direct(jf, ja, tx, ty, cj, return_packed=True)
    pad = nc - feats.shape[1]
    (jf, ja), _ = _both(np.pad(feats, ((0, 0), (0, pad))),
                        {k: np.pad(v, (0, pad)) for k, v in aux.items()})
    ref = jbin.bin_eval_direct(jf, ja, tx, ty, cj, return_packed=True)
    ours = tbin.bin_eval_direct(tf, ta, tx, ty, ct, return_packed=True)
    _eq(ours[1], ref[1], "tile_start")
    _eq(ours[2], ref[2], "tile_stop")
    _eq(ours[3], ref[3], "num_instances")
    live = int(ref[2][-1])
    assert live > 0
    for i, col in enumerate(ref[0]):
        _eq(ours[0][i][:live], _u32(col)[:live], f"sorted column {i}")


def test_eval_variant_matches_jax():
    """Field for field, at several grids and configs, including both
    fallbacks (the grid over 63x31 tiles, kmax below 6) and tiles other
    than 16 px."""
    kws = [dict(compact=256, kmax=8, ksmall=4, nlarge=64),
           dict(compact=2**15, kmax=8, ksmall=4, nlarge=2**13),
           dict(compact=2**16, kmax=16),
           dict(compact=256, kmax=4),
           dict(compact=256, kmax=8, tile=8),
           dict(compact=256, kmax=31, nmid=64, kmid=10, ksmall=3, nlarge=8)]
    for kw in kws:
        kw = dict({"tile": 16}, **kw)
        cj = jpre.RasterConfig(**kw)
        ct = tpre.RasterConfig(**kw)
        for w, h in ((48, 32), (256, 256), (480, 480), (640, 480),
                     (1200, 680), (1008, 496), (1008, 512)):
            ej, et = cj.eval_variant(w, h), ct.eval_variant(w, h)
            assert dataclasses.asdict(et) == dataclasses.asdict(ej), (kw, w, h)
    rc = tpre.RasterConfig(tile=16, compact=256, kmax=8, chunk=64, ksmall=4,
                           nlarge=64)
    ev = rc.eval_variant(48, 32)
    assert ev.sel_direct and ev.pack8 and ev.nmid and ev.kmid == 4
    assert rc.eval_variant(1200, 680) == rc
    rc2 = tpre.RasterConfig(tile=16, compact=256, kmax=4, chunk=64)
    assert rc2.eval_variant(48, 32) == rc2


def test_packed_binning_guards():
    feats, aux = _blend_inputs(n=40, big=4)
    _, (tf, ta) = _both(feats, aux)
    with pytest.raises(ValueError, match="kanchor"):
        tbin.compact_gaussians_packed(tf, ta, tpre.RasterConfig(
            compact=64, kmax=8, kanchor=2, kgroup=4))
    with pytest.raises(ValueError, match="kmax"):
        tbin.compact_gaussians_packed(tf, ta, tpre.RasterConfig(
            compact=64, kmax=32))
    pc = tbin.compact_gaussians_packed(tf, ta, tpre.RasterConfig(
        compact=64, kmax=8))
    with pytest.raises(ValueError, match="63"):
        tbin.expand_and_sort_packed(pc, 64, 2, tpre.RasterConfig(
            compact=64, kmax=8))
    with pytest.raises(ValueError, match="31"):
        tbin.bin_eval_direct(tf, ta, 6, 32, tpre.RasterConfig(
            compact=64, kmax=8, ksmall=2, nlarge=8, sel_direct=True,
            pack8=True), return_packed=True)
