"""The port's kanchor pre-compaction (RasterConfig.kanchor: each anchor's
kanchor first offsets by priority, kept before the packed eval binning's
global sort) against the JAX package on the CPU. The compaction's rows and
the direct selection's sorted columns, tile ranges and counts equal JAX's
bit for bit with kanchor on, both where no anchor has more than kanchor
alive offsets (then they also equal the rows without kanchor) and where
some have more; the eval image under overflow stays close to the image
without kanchor (tests/test_packed_binning.py:314-372) and within 2e-4 of
JAX's kanchor image; the apps' flag sets kanchor and kgroup as JAX's does.
"""

import argparse
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segs_slam_tpu.apps import common as jcommon
from segs_slam_tpu.models.renderer import ChainedEvalRenderer as JChained
from segs_slam_tpu.ops.rasterizer import binning as jbin
from segs_slam_tpu_torch.apps import common
from segs_slam_tpu_torch.models.renderer import ChainedEvalRenderer
from segs_slam_tpu_torch.ops.rasterizer import binning as tbin
from test_torch_eval_binning import W, H, _blend_inputs, _both, _configs, \
    _eq, _u32
from test_torch_eval_render import _configs as _render_configs
from test_torch_eval_render import _scene
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

KG = 4  # kgroup: the offsets an anchor


def _grouped_inputs(max_alive=None, seed=0):
    """test_torch_eval_binning's 300 rows read as 75 anchors of KG offsets;
    with max_alive, each anchor's offsets beyond its first max_alive alive
    ones are dead, so the pre-compaction is lossless at kanchor =
    max_alive."""
    feats, aux = _blend_inputs(seed=seed)
    if max_alive is not None:
        alive = aux["alive"].reshape(-1, KG)
        alive &= np.cumsum(alive, axis=1) <= max_alive
        aux["alive"] = alive.reshape(-1)
    return feats, aux


def _overflowing(aux, ka):
    return int((aux["alive"].reshape(-1, KG).sum(axis=1) > ka).sum())


CASES = [("lossless", 2, 2), ("overflow", None, 2), ("overflow_ka3", None, 3)]


@pytest.mark.parametrize("case,max_alive,ka", CASES)
@pytest.mark.parametrize("compact", [128, 256], ids=["cut", "padded"])
def test_compaction_matches_jax(case, max_alive, ka, compact):
    """compact_gaussians_packed with kanchor: every column bit-equal to
    JAX's (compact 256 pads the kept rows up to the capacity)."""
    feats, aux = _grouped_inputs(max_alive)
    (jf, ja), (tf, ta) = _both(feats, aux)
    kw = dict(compact=compact, kmax=16)
    cj, ct = _configs(kanchor=ka, kgroup=KG, **kw)
    pc_j = jbin.compact_gaussians_packed(jf, ja, cj)
    pc_t = tbin.compact_gaussians_packed(tf, ta, ct)
    for i, name in enumerate(("p_xy", "p_cab", "p_cco", "p_rg", "p_b")):
        _eq(pc_t.cols[i], _u32(getattr(pc_j, name)), name)
    _eq(pc_t.dmeta, _u32(pc_j.dmeta), "dmeta")
    _eq(pc_t.valid, pc_j.valid, "valid")
    assert int(pc_t.num_valid) == int(pc_j.num_valid)
    # the training compaction (with_orig) ignores kanchor, as in JAX
    assert tbin.compact_gaussians_packed(tf, ta, ct, with_orig=True) \
        .valid.sum() == tbin.compact_gaussians_packed(
            tf, ta, _configs(**kw)[1], with_orig=True).valid.sum()

    plain = tbin.compact_gaussians_packed(tf, ta, _configs(**kw)[1])
    rows = lambda pc: sorted(zip(  # noqa: E731
        *[c[pc.valid].tolist() for c in (*pc.cols, pc.dmeta)]))
    if case == "lossless":
        # the same rows survive
        assert _overflowing(aux, ka) == 0
        assert rows(pc_t) == rows(plain)
    else:
        assert _overflowing(aux, ka) > 0
        assert rows(pc_t) != rows(plain)


@pytest.mark.parametrize("case,max_alive,ka", CASES)
@pytest.mark.parametrize("pack8", [False, True], ids=["f16", "pack8"])
def test_bin_eval_direct_matches_jax(case, max_alive, ka, pack8):
    """bin_eval_direct with kanchor on the footprint-primary key: sorted
    columns, tile ranges, num_instances and num_valid bit-equal to JAX's
    (compact 128 of the 150 or 225 kept rows: JAX's bin_eval_direct cannot
    pad)."""
    feats, aux = _grouped_inputs(max_alive, seed=2)
    (jf, ja), (tf, ta) = _both(feats, aux)
    kw = dict(compact=128, kmax=16, ksmall=2, kmid=8, nmid=64, nlarge=32,
              sel_direct=True, pack8=pack8)
    cj, ct = _configs(kanchor=ka, kgroup=KG, **kw)
    tx, ty = ct.grid(W, H)
    ref = jbin.bin_eval_direct(jf, ja, tx, ty, cj, return_packed=True)
    ours = tbin.bin_eval_direct(tf, ta, tx, ty, ct, return_packed=True)
    assert len(ref[0]) == ours[0].shape[0]
    for i, col in enumerate(ref[0]):
        _eq(ours[0][i], _u32(col), f"sorted column {i}")
    for i, name in ((1, "tile_start"), (2, "tile_stop"),
                    (3, "num_instances"), (4, "num_valid")):
        _eq(ours[i], ref[i], name)
    assert int(ours[3]) > 0
    plain = tbin.bin_eval_direct(tf, ta, tx, ty, _configs(**kw)[1],
                                 return_packed=True)
    if case == "lossless":
        assert int(plain[3]) == int(ours[3])
        torch.testing.assert_close(plain[1], ours[1], rtol=0, atol=0)
    else:
        assert _overflowing(aux, ka) > 0


@pytest.mark.parametrize("ka", [3, 2], ids=["lossless", "overflow"])
def test_image_close_under_overflow(ka):
    """test_packed_binning's kanchor scene (48 anchors of 4 offsets, each
    visible one with 3 alive): the eval image within 2e-4 of JAX's kanchor
    image; at kanchor 3 (JAX's case) equal to the image without kanchor, at
    kanchor 2 every visible anchor overflows and the mean error against it
    stays below 2e-2."""
    jmc, ja, jd, jcam, mc, anchors, dec, cam = _scene(seed=11, n=48)
    kw = dict(compact=256, kmax=8)
    rt0 = _render_configs(**kw)[1]
    rj1, rt1 = _render_configs(kanchor=ka, kgroup=mc.n_offsets, **kw)
    chain = ChainedEvalRenderer(mc, rt0, 48, 32, torch.zeros(3),
                                device="cpu")
    feats, aux = chain.project(chain.decode(anchors, dec, cam), cam)
    overflow = int((aux["alive"].reshape(-1, mc.n_offsets).sum(dim=1)
                    > ka).sum())
    ref = chain.blend(feats, aux).numpy()
    kan = ChainedEvalRenderer(mc, rt1, 48, 32, torch.zeros(3),
                              device="cpu")(anchors, dec, cam).numpy()
    jkan = np.asarray(JChained(jmc, rj1, 48, 32, jnp.zeros(3),
                               interpret=True)(ja, jd, jcam))
    assert ref.max() > 0.0
    np.testing.assert_allclose(kan, jkan, atol=2e-4, rtol=0)
    if ka == 3:
        assert overflow == 0
        np.testing.assert_array_equal(kan, ref)
    else:
        assert overflow > 10
        assert 0 < np.abs(kan - ref).max()
        assert np.abs(kan - ref).mean() < 2e-2


def test_kanchor_flag_resolves_as_jax():
    """--kanchor N sets kanchor = N and kgroup = n_offsets, as JAX's
    resolve_configs does; 0 leaves both off."""
    for extra in (["--kanchor", "4"],
                  ["--kanchor", "2", "--model-set", "n_offsets=4"], []):
        got = []
        for mod in (common, jcommon):
            p = argparse.ArgumentParser()
            mod.add_common_args(p)
            rc = mod.resolve_configs(p.parse_args(extra), 10)[3]
            got.append((rc.kanchor, rc.kgroup))
        assert got[0] == got[1], extra
    assert got[0] == (0, 0)


@pytest.mark.cuda
def test_kanchor_eval_render_on_card_matches_cpu():
    """The kanchor eval render (the direct selection, pack8, K3) on the
    card against the CPU path's plain version, in the overflow case."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K3 is CUDA C++ with no CPU mode)")
    from segs_slam_tpu_torch.models.renderer import EvalRenderer

    *_, mc, anchors, dec, cam = _scene(seed=11, n=48)
    rt = _render_configs(compact=256, kmax=8, ksmall=2, nlarge=64, kanchor=2,
                         kgroup=mc.n_offsets)[1].eval_variant(48, 32)
    assert rt.sel_direct and rt.kanchor == 2
    imgs = []
    for dev in ("cpu", "cuda"):
        a = dataclasses.replace(anchors, **{
            f.name: getattr(anchors, f.name).to(dev)
            for f in dataclasses.fields(anchors)})
        imgs.append(EvalRenderer(mc, rt, 48, 32, torch.zeros(3), device=dev)(
            a, dec.to(dev), {k: v.to(dev) for k, v in cam.items()}).cpu())
    np.testing.assert_allclose(imgs[1].numpy(), imgs[0].numpy(), atol=2e-4)
