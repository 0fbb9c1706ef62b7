"""The port's packed training binning (RasterConfig.packed_train) against the
JAX package: `expand_and_sort_packed_train` bit for bit; the packed
`binned_blend` forward and gradients against JAX's packed path (Pallas in
interpret mode); the port's packed path against its own f32 path within
tests/test_packed_binning.py's bounds; and the gate that sends a grid wider
than 63 tiles to the f32 binning in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segs_slam_tpu.ops.rasterizer import binning as jbin
from segs_slam_tpu.ops.rasterizer.blend import binned_blend as j_binned_blend
from segs_slam_tpu_torch.ops.rasterizer import binning as tbin
from segs_slam_tpu_torch.ops.rasterizer import blend as tblend
from test_torch_eval_binning import W, H, _blend_inputs, _both, _configs, _eq
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

ROWS = ["mean2d.x", "mean2d.y", "conic.a", "conic.b", "conic.c", "opacity",
        "r", "g", "b"]
CASES = [
    ("dual_rate", dict(compact=512, kmax=16, ksmall=4, nlarge=64)),
    ("flat", dict(compact=512, kmax=16)),
    ("overflow", dict(compact=128, kmax=8, ksmall=2, nlarge=16)),
]


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("case,kw", CASES)
def test_expand_and_sort_packed_train_matches_jax(case, kw):
    """Compaction ids, sorted features (their depth row is the sorted
    keys' depth bits), gid_sorted, tile ranges and counts, bit for bit."""
    feats, aux = _blend_inputs(seed=2)
    (jf, ja), (tf, ta) = _both(feats, aux)
    cj, ct = _configs(packed_train=True, **kw)
    tx, ty = ct.grid(W, H)
    pj = jbin.compact_gaussians_packed(jf, ja, cj, with_orig=True)
    pt = tbin.compact_gaussians_packed(tf, ta, ct, with_orig=True)
    _eq(pt.orig_id, pj.orig_id, "orig_id")
    _eq(pt.valid, pj.valid, "valid")
    ref = jbin.expand_and_sort_packed_train(pj, tx, ty, cj)
    ours = tbin.expand_and_sort_packed_train(pt, tx, ty, ct)
    assert ours.feats_sorted.shape == (10, ct.max_instances)
    for i, row in enumerate(ROWS + ["depth"]):
        np.testing.assert_array_equal(_bits(ours.feats_sorted[i].numpy()),
                                      _bits(ref.feats_sorted[i]),
                                      err_msg=row)
    for name in ("gid_sorted", "tile_start", "tile_stop", "num_instances",
                 "num_large"):
        _eq(getattr(ours, name), getattr(ref, name), name)
    assert int(ours.num_instances) > 0
    if case == "overflow":
        assert int(pt.num_valid) > ct.compact


def _scene_blend(kw, seed=4):
    feats, aux = _blend_inputs(seed=seed)
    tx, ty = _configs(**kw)[1].grid(W, H)
    rng = np.random.default_rng(seed + 1)
    nt = tx * ty
    cot = (rng.normal(size=(nt, 3, 256)).astype(np.float32),
           rng.normal(size=(nt, 1, 256)).astype(np.float32),
           (0.3 * rng.normal(size=(nt, 1, 256))).astype(np.float32))
    bg = np.array([0.1, 0.3, 0.2], np.float32)
    return feats, aux, tx, ty, cot, bg


def _torch_blend(feats, aux, bg, cfg, tx, ty, cot):
    """The port's binned_blend outputs and the gradients of the cotangents'
    inner product: (outs, d feats [9, N], d depth, d bg)."""
    f_t = torch.tensor(feats, requires_grad=True)
    d_t = torch.tensor(aux["depth"], requires_grad=True)
    bg_t = torch.tensor(bg, requires_grad=True)
    aux_t = {k: torch.tensor(v) for k, v in aux.items() if k != "depth"}
    out = tblend.binned_blend(f_t, dict(aux_t, depth=d_t), bg_t, cfg, tx, ty)
    loss = sum((o * torch.as_tensor(c)).sum() for o, c in zip(out[:3], cot))
    return (out, *torch.autograd.grad(loss, (f_t, d_t, bg_t)))


def _scaled_close(ours, ref, name, tol=2e-4):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert np.isfinite(ours).all(), name
    scale = np.abs(ref).max() + 1e-12
    np.testing.assert_allclose(ours / scale, ref / scale, atol=tol, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("case,kw", CASES[:2])
def test_packed_binned_blend_matches_jax(case, kw):
    """Forward within 2e-4, n_contrib equal, gradients within 2e-4 of each
    row's largest, against jax.vjp of JAX's packed binned_blend."""
    feats, aux, tx, ty, cot, bg = _scene_blend(kw)
    cj, ct = _configs(packed_train=True, **kw)
    aux_j = {k: jnp.asarray(v) for k, v in aux.items() if k != "depth"}

    def j_fn(f, d, b):
        return j_binned_blend(f, dict(aux_j, depth=d), b,
                              (cj, tx, ty, 256, True))

    j_out, vjp = jax.vjp(j_fn, tuple(jnp.asarray(f) for f in feats),
                         jnp.asarray(aux["depth"]), jnp.asarray(bg))
    j_df, j_dd, j_dbg = vjp(tuple(jnp.asarray(c) for c in cot)
                            + tuple(jnp.zeros_like(o) for o in j_out[3:]))
    before = dict(tblend.train_binnings)
    out, df, dd, dbg = _torch_blend(feats, aux, bg, ct, tx, ty, cot)
    assert tblend.train_binnings["packed"] == before["packed"] + 1
    for name, a, b in zip(("color", "final_T", "depth"), out[:3], j_out[:3]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=2e-4, rtol=0, err_msg=name)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(j_out[3]))
    assert int(out[4]) == int(j_out[4]) and int(out[5]) == int(j_out[5])
    for i, row in enumerate(ROWS):
        _scaled_close(df[i].numpy(), j_df[i], row)
    _scaled_close(dd.numpy(), j_dd, "depth")
    np.testing.assert_allclose(dbg.numpy(), np.asarray(j_dbg), rtol=1e-5,
                               atol=1e-4)
    assert np.abs(np.asarray(j_df[5])).max() > 0


def test_packed_train_close_to_f32_binning():
    """The port's packed path against its f32 path: the image within max
    2e-2 and mean 2e-3, every gradient row within 0.05 of its largest and
    pointing the same way (cosine > 0.99), as tests/test_packed_binning.py
    holds the JAX package's two paths."""
    kw = dict(compact=512, kmax=16, ksmall=4, nlarge=64)
    feats, aux, tx, ty, cot, bg = _scene_blend(kw, seed=6)
    _, f32_cfg = _configs(**kw)
    _, pk_cfg = _configs(packed_train=True, **kw)
    ref = _torch_blend(feats, aux, bg, f32_cfg, tx, ty, cot)
    got = _torch_blend(feats, aux, bg, pk_cfg, tx, ty, cot)
    d = (got[0][0] - ref[0][0]).detach().abs()
    assert float(ref[0][0].detach().max()) > 0.0
    assert float(d.max()) <= 2e-2 and float(d.mean()) < 2e-3
    grads = [(ROWS[i], got[1][i], ref[1][i]) for i in range(9)]
    for name, b, a in grads + [("depth", got[2], ref[2])]:
        a, b = a.numpy(), b.numpy()
        scale = np.abs(a).max()
        assert np.isfinite(b).all(), name
        if scale == 0:
            continue
        np.testing.assert_allclose(b, a, atol=0.05 * scale + 1e-6,
                                   err_msg=name)
        cos = (a * b).sum() / max(np.linalg.norm(a) * np.linalg.norm(b),
                                  1e-12)
        assert cos > 0.99, (name, cos)


def test_wide_grid_takes_f32_binning_in_both():
    """At 1,040 px (65 tile columns) packed_train falls to the f32 binning
    in JAX (blend.py:962-964) and in the port: the outputs equal those of
    packed_train off."""
    w, h, n = 1040, 16, 60
    rng = np.random.default_rng(7)
    x = rng.uniform(0, w, n).astype(np.float32)
    feats = np.stack([x, rng.uniform(0, h, n), np.full(n, 0.05),
                      np.zeros(n), np.full(n, 0.05), rng.uniform(0.2, 0.9, n),
                      *rng.uniform(0, 1, (3, n))]).astype(np.float32)
    aux = {"rect_min_x": np.clip((x - 8) // 16, 0, 64).astype(np.int32),
           "rect_min_y": np.zeros(n, np.int32),
           "rect_w": np.full(n, 2, np.int32),
           "touched": np.full(n, 2, np.int32),
           "depth": rng.uniform(1, 5, n).astype(np.float32),
           "alive": np.ones(n, bool)}
    kw = dict(compact=128, kmax=8, ksmall=2, nlarge=16)
    tx, ty = _configs(**kw)[1].grid(w, h)
    assert tx == 65 and _configs(packed_train=True, **kw)[1].train_binning(
        tx, ty) == "f32"
    (jf, ja), (tf, ta) = _both(feats, aux)
    outs = {}
    for packed in (False, True):
        cj, ct = _configs(packed_train=packed, **kw)
        before = tblend.train_binnings["f32"]
        outs[packed] = (
            j_binned_blend(jf, ja, jnp.zeros(3), (cj, tx, ty, 256, True)),
            tblend.binned_blend(tf, ta, torch.zeros(3), ct, tx, ty))
        assert tblend.train_binnings["f32"] == before + 1
    for (j0, t0), (j1, t1) in [(outs[False], outs[True])]:
        for a, b in zip(j0[:4], j1[:4]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(t0[:4], t1[:4]):
            assert torch.equal(a, b)
        np.testing.assert_allclose(t1[0].numpy(), np.asarray(j1[0]),
                                   atol=2e-4)
    assert float(outs[True][1][0].max()) > 0.0
