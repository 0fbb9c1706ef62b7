"""The whole slice: the port's render() against the JAX package's render()
(Pallas blend in interpret mode) on a small map, and the port's render_views
app end to end on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from segs_slam_tpu.apps.render_views import orbit_poses as j_orbit_poses
from segs_slam_tpu.core import Camera
from segs_slam_tpu.core.keyframe import Keyframe
from segs_slam_tpu.models import anchors as janchors
from segs_slam_tpu.models.config import ModelConfig as JModelConfig
from segs_slam_tpu.models.decoders import init_decoders
from segs_slam_tpu.models.renderer import render as j_render
from segs_slam_tpu.ops.rasterizer import RasterConfig as JRasterConfig
from segs_slam_tpu_torch.apps import render_views
from segs_slam_tpu_torch.io.convert import (
    anchors_from_numpy,
    decoders_from_jax,
    flatten_params,
    save_map,
)
from segs_slam_tpu_torch.io.png import write_png
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.models.renderer import render
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

W, H = 48, 32
SMALL = dict(capacity=64, feat_dim=8, n_offsets=4, appearance_dim=8)


def _map(seed=0, n_active=56):
    """A small seeded map (anchors numpy dict, JAX decoder params)."""
    jmc = JModelConfig(**SMALL)
    rng = np.random.default_rng(seed)
    cap, k, f = jmc.capacity, jmc.n_offsets, jmc.feat_dim
    st = janchors.empty_state(jmc)
    active = np.zeros(cap, bool)
    active[:n_active] = True
    anchors = {name: np.asarray(v) for name, v in st._asdict().items()}
    anchors.update(
        anchor=rng.uniform([-1, -0.7, 2.5], [1, 0.7, 5], (cap, 3)),
        offset=rng.normal(0, 0.4, (cap, k, 3)),
        feat=rng.normal(0, 1.0, (cap, f)),
        scaling=np.full((cap, 6), np.log(0.08)),
        active=active)
    anchors = {n: v.astype(np.float32) if v.dtype != bool else v
               for n, v in anchors.items()}
    return anchors, init_decoders(jax.random.PRNGKey(seed), jmc)


@pytest.mark.parametrize("case,cfg_kw", [
    ("dual_rate", dict(compact=256, kmax=8, ksmall=4, nlarge=64)),
    ("compact_overflow", dict(compact=48, kmax=8)),
])
def test_render_matches_jax(case, cfg_kw):
    anchors, params = _map()
    cam = Camera(camera_id=0, width=W, height=H, fx=40.0, fy=40.0,
                 cx=W / 2, cy=H / 2)
    kf = Keyframe(kf_id=0, camera=cam, quat=[0.995, 0.03, -0.09, 0.01],
                  trans=[0.1, 0.05, -0.2])
    cam_np = kf.render_inputs()
    bg = np.array([0.1, 0.2, 0.3], np.float32)

    ref = j_render(janchors.AnchorState(**{n: jnp.asarray(v) for n, v in
                                            anchors.items()}),
                   params, {k: jnp.asarray(v) for k, v in cam_np.items()},
                   W, H, jnp.asarray(bg), JModelConfig(**SMALL),
                   JRasterConfig(tile=16, chunk=64, **cfg_kw),
                   interpret=True)
    with torch.inference_mode():
        ours = render(anchors_from_numpy(anchors),
                      decoders_from_jax(flatten_params(params)),
                      {k: torch.as_tensor(v) for k, v in cam_np.items()},
                      W, H, torch.as_tensor(bg), ModelConfig(**SMALL),
                      RasterConfig(tile=16, chunk=64, **cfg_kw))

    np.testing.assert_allclose(ours.image.numpy(), np.asarray(ref.image),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(ours.final_T.numpy(), np.asarray(ref.final_T),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(ours.depth_map.numpy(),
                               np.asarray(ref.depth_map), atol=1e-3, rtol=0)
    for name in ("num_compact", "num_instances", "num_kmax_truncated"):
        assert int(getattr(ours, name)) == int(getattr(ref, name)), name
    for name in ("radii", "visible_anchor_mask"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert (ours.image - torch.as_tensor(bg)[:, None, None]).abs().max() > 0.1
    if case == "compact_overflow":
        assert int(ours.num_compact) > cfg_kw["compact"]


def test_orbit_poses_match_jax_app():
    center = np.array([0.2, -0.1, 3.0])
    ours = render_views.orbit_poses(center, 1.5, -0.3, 5,
                                    center + np.array([0, 0, 0.5]))
    ref = j_orbit_poses(center, 1.5, -0.3, 5, center + np.array([0, 0, 0.5]))
    for (q, t), (qr, tr) in zip(ours, ref):
        np.testing.assert_allclose(q, qr, atol=1e-6)
        np.testing.assert_allclose(t, tr, atol=1e-12)


def test_render_views_app_on_cpu(tmp_path):
    anchors, params = _map(seed=1)
    path = tmp_path / "map.npz"
    save_map(path, anchors, jax.tree.map(np.asarray, params))
    out = tmp_path / "frames"
    views = render_views.main([
        "--map", str(path), "--out", str(out), "--size", "32",
        "--orbit-frames", "3", "--orbit-radius", "4.0", "--compact", "256",
        "--nlarge", "64", "--device", "cpu"])
    assert len(views) == 3
    for i, v in enumerate(views):
        assert v["image"].shape == (3, 32, 32)
        assert np.isfinite(v["image"]).all()
        assert v["image"].min() >= 0 and v["image"].max() <= 1 + 1e-6
        assert v["num_compact"] > 0 and v["num_instances"] > 0
        png = np.asarray(Image.open(out / f"view{i:04d}.png"))
        want = (np.clip(v["image"].transpose(1, 2, 0), 0, 1) * 255).astype(
            np.uint8)
        np.testing.assert_array_equal(png, want)
    assert max(v["image"].max() for v in views) > 0.05


def test_png_writer_round_trip(tmp_path):
    rgb = np.random.default_rng(0).integers(0, 256, (7, 5, 3), np.uint8)
    write_png(tmp_path / "x.png", rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "x.png")),
                                  rgb)
    with pytest.raises(ValueError):
        write_png(tmp_path / "y.png", rgb.astype(np.float32))
