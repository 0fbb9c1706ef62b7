"""Parity of the port's model modules (decoders, neural-gaussian decode, knn,
anchor insertion, map conversion) with the JAX package at 1e-5, with weights
carried over by segs_slam_tpu_torch.io.convert."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segs_slam_tpu.models import anchors as janchors
from segs_slam_tpu.models.config import ModelConfig as JModelConfig
from segs_slam_tpu.models.decoders import DecoderApply, init_decoders
from segs_slam_tpu.models.neural_gaussians import (
    generate_neural_gaussians as j_generate,
)
from segs_slam_tpu.ops.knn import mean_knn_sq_dist as j_knn
from segs_slam_tpu_torch.io.convert import (
    anchors_from_numpy,
    decoders_from_jax,
    flatten_params,
    load_map,
    save_map,
)
from segs_slam_tpu_torch.models import anchors as tanchors
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.models.decoders import Decoders
from segs_slam_tpu_torch.models.neural_gaussians import (
    generate_neural_gaussians,
)
from segs_slam_tpu_torch.ops.knn import mean_knn_sq_dist
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

SMALL = dict(capacity=64, feat_dim=8, n_offsets=4, appearance_dim=8,
             embedding_dim=5)
VARIANTS = {
    "default": {},
    "feat_bank_dist": dict(use_feat_bank=True, add_opacity_dist=True,
                           add_cov_dist=True, add_color_dist=True),
    "no_appearance": dict(appearance_dim=0),
}
TOL = dict(atol=1e-5, rtol=1e-5)


def _configs(variant):
    kw = dict(SMALL, **VARIANTS[variant])
    return JModelConfig(**kw), ModelConfig(**kw)


def _jax_state(jmc, seed=0, n_active=48):
    rng = np.random.default_rng(seed)
    cap, k, f = jmc.capacity, jmc.n_offsets, jmc.feat_dim
    st = janchors.empty_state(jmc)
    active = np.zeros(cap, bool)
    active[:n_active] = True
    return st._replace(
        anchor=jnp.asarray(rng.uniform([-1, -1, 2], [1, 1, 5], (cap, 3)),
                           jnp.float32),
        offset=jnp.asarray(rng.normal(0, 0.3, (cap, k, 3)), jnp.float32),
        feat=jnp.asarray(rng.normal(0, 0.5, (cap, f)), jnp.float32),
        scaling=jnp.asarray(rng.normal(-2.5, 0.3, (cap, 6)), jnp.float32),
        active=jnp.asarray(active),
    )


def _to_torch_state(st):
    return anchors_from_numpy({k: np.asarray(v)
                               for k, v in st._asdict().items()})


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_decoders_match_jax(variant):
    jmc, mc = _configs(variant)
    params = init_decoders(jax.random.PRNGKey(1), jmc)
    dec = decoders_from_jax(flatten_params(params))
    want = dataclasses.replace(mc, capacity=ModelConfig().capacity)
    if not mc.appearance_dim:  # no table to read embedding_dim from
        want = dataclasses.replace(want,
                                   embedding_dim=ModelConfig().embedding_dim)
    assert dec.config == want
    rng = np.random.default_rng(2)
    x_op = rng.normal(size=(10, jmc.opacity_in)).astype(np.float32)
    x_cov = rng.normal(size=(10, jmc.cov_in)).astype(np.float32)
    x_col = rng.normal(size=(10, jmc.color_in)).astype(np.float32)
    pairs = [(DecoderApply.opacity, dec.decode_opacity, x_op),
             (DecoderApply.cov, dec.decode_cov, x_cov),
             (DecoderApply.color, dec.decode_color, x_col)]
    if jmc.appearance_dim:
        pairs.append((DecoderApply.appearance, dec.decode_appearance,
                      rng.normal(size=(1, 7)).astype(np.float32)))
    if jmc.use_feat_bank:
        pairs.append((DecoderApply.feat_bank, dec.decode_feat_bank,
                      rng.normal(size=(10, 4)).astype(np.float32)))
    with torch.no_grad():
        for jfn, tfn, x in pairs:
            np.testing.assert_allclose(
                tfn(torch.as_tensor(x)).numpy(),
                np.asarray(jfn(params, jnp.asarray(x))), **TOL)


def test_decoders_init_is_seeded_and_bounded():
    mc = ModelConfig(**SMALL)
    a = Decoders(mc, torch.Generator().manual_seed(3))
    b = Decoders(mc, torch.Generator().manual_seed(3))
    names = {n for n, _ in a.named_parameters()}
    assert names == {f"{m}.{l}.{p}" for m in ("opacity", "cov", "color")
                     for l in ("l1", "l2") for p in ("weight", "bias")} | {
        "appearance.weight", "appearance.bias", "embedding.table"}
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
        if n.endswith(("weight", "bias")) and n != "embedding.table":
            fan_in = dict(a.named_modules())[n.rsplit(".", 1)[0]].in_features
            assert p.abs().max() <= 1 / np.sqrt(fan_in)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_neural_gaussians_match_jax(variant):
    jmc, mc = _configs(variant)
    params = init_decoders(jax.random.PRNGKey(4), jmc)
    st = _jax_state(jmc, seed=5)
    rng = np.random.default_rng(6)
    cam_center = rng.normal(size=3).astype(np.float32)
    pose7 = rng.normal(size=7).astype(np.float32)
    visible = rng.uniform(size=jmc.capacity) > 0.3
    ref = j_generate(st, params, jnp.asarray(cam_center), jnp.asarray(pose7),
                     jnp.asarray(visible), jmc)
    with torch.no_grad():
        ours = generate_neural_gaussians(
            _to_torch_state(st), decoders_from_jax(flatten_params(params)),
            torch.as_tensor(cam_center), torch.as_tensor(pose7),
            torch.as_tensor(visible), mc)
    for name in ref._fields:
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def test_knn_matches_jax():
    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 1, (700, 3)).astype(np.float32)
    valid = rng.uniform(size=700) > 0.1
    ref = np.asarray(j_knn(jnp.asarray(pts), jnp.asarray(valid), block=256))
    ours = mean_knn_sq_dist(torch.as_tensor(pts), torch.as_tensor(valid),
                            block=256).numpy()
    np.testing.assert_allclose(ours, ref, **TOL)
    assert (ours[~valid] == 0).all()
    # fewer than k other points: the mean is inf, as in the JAX version
    two = mean_knn_sq_dist(torch.as_tensor(pts[:2]))
    assert torch.isinf(two).all()


def test_insert_points_matches_jax():
    kw = dict(SMALL, capacity=400, voxel_size=0.05)
    jmc, mc = JModelConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(8)
    batches = [rng.uniform(0, 1, (150, 3)), rng.uniform(0.5, 2, (120, 3)),
               rng.uniform(-1, 0, (300, 3))]  # the last overflows capacity
    jst, tst = janchors.empty_state(jmc), tanchors.empty_state(mc)
    for pts in batches:
        jst, jn = janchors.insert_points(jst, pts, jmc)
        tst_before = tst
        tst, tn = tanchors.insert_points(tst, pts, mc)
        assert tn == jn
        for name, ref in jst._asdict().items():
            a, b = getattr(tst, name).numpy(), np.asarray(ref)
            if b.dtype == bool:
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    assert int(tst.num_active()) == mc.capacity
    assert int(tst_before.num_active()) < mc.capacity  # input not mutated
    assert tanchors.insert_points(tst, batches[0], mc) == (tst, 0)


def test_map_file_round_trip(tmp_path):
    jmc, mc = _configs("default")
    params = init_decoders(jax.random.PRNGKey(9), jmc)
    st = _jax_state(jmc, seed=10)
    path = tmp_path / "map.npz"
    save_map(path, {k: np.asarray(v) for k, v in st._asdict().items()},
             jax.tree.map(np.asarray, params))
    anchors, dec = load_map(path)
    for name, ref in st._asdict().items():
        np.testing.assert_array_equal(getattr(anchors, name).numpy(),
                                      np.asarray(ref), err_msg=name)
    assert anchors.active.dtype == torch.bool
    np.testing.assert_array_equal(dec.opacity.l1.weight.detach().numpy(),
                                  np.asarray(params["opacity"]["l1"]["w"]).T)
    np.testing.assert_array_equal(dec.embedding.table.detach().numpy(),
                                  np.asarray(params["embedding"]["table"]))
    empty_t, empty_j = tanchors.empty_state(mc), janchors.empty_state(jmc)
    for name, ref in empty_j._asdict().items():
        np.testing.assert_array_equal(getattr(empty_t, name).numpy(),
                                      np.asarray(ref), err_msg=name)
