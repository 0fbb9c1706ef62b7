"""The port's densification, Trainer, synthetic scene, Scene sampler, PLY
and train-state conversion against the JAX package on the CPU, and the
train_synthetic app end to end on the CPU at a tiny size.

Densification is compared with JAX's random keep-masks injected (torch's
generator draws other numbers), and must equal JAX's state up to f32
rounding. The Trainer is compared over a few iterations from one state:
losses within rtol 1e-4 (the per-step gradient tolerances are in
tests/test_torch_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segs_slam_tpu.core import Camera as JCamera
from segs_slam_tpu.core.keyframe import Keyframe as JKeyframe
from segs_slam_tpu.models.anchors import empty_state as j_empty_state
from segs_slam_tpu.models.anchors import insert_points as j_insert_points
from segs_slam_tpu.models.config import ModelConfig as JModelConfig
from segs_slam_tpu.models.decoders import init_decoders
from segs_slam_tpu.ops.rasterizer import RasterConfig as JRasterConfig
from segs_slam_tpu.slam.scene import Scene as JScene
from segs_slam_tpu.train.config import OptimizationConfig as JOptConfig
from segs_slam_tpu.train.densify import make_adjust_anchor as j_make_adjust
from segs_slam_tpu.train.step import init_train_state as j_init_train_state
from segs_slam_tpu.train.step import make_train_step as j_make_train_step
from segs_slam_tpu.train.trainer import Trainer as JTrainer
from segs_slam_tpu.utils import synthetic as jsynth
from segs_slam_tpu_torch.apps import train_synthetic
from segs_slam_tpu_torch.core import Camera, Keyframe
from segs_slam_tpu_torch.io.convert import (
    decoders_from_jax,
    flatten_params,
    train_state_from_jax,
    train_state_to_numpy,
)
from segs_slam_tpu_torch.io.ply import load_anchor_ply
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from segs_slam_tpu_torch.slam.scene import Scene
from segs_slam_tpu_torch.train.config import OptimizationConfig
from segs_slam_tpu_torch.train.densify import (
    adjust_anchor,
    keep_probability,
    make_adjust_anchor,
)
from segs_slam_tpu_torch.train.step import make_train_step
from segs_slam_tpu_torch.train.trainer import Trainer
from segs_slam_tpu_torch.utils import synthetic
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

W, H = 32, 32
SMALL = dict(feat_dim=8, n_offsets=4, appearance_dim=8, embedding_dim=4,
             capacity=64, voxel_size=0.05)
OPT = dict(start_stat=2, update_from=4, update_interval=5, update_until=100,
           use_frequency_regularization=False)
RASTER = dict(tile=16, compact=512, kmax=32, chunk=64)


def _tree(x):
    """NamedTuples and dicts as nested dicts of numpy arrays."""
    if hasattr(x, "_asdict"):
        x = x._asdict()
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return np.asarray(x)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _keyframes(cls_cam, cls_kf, n=3, seed=0):
    rng = np.random.default_rng(seed)
    cam = cls_cam(camera_id=0, width=W, height=H, fx=30.0, fy=30.0, cx=16,
                  cy=16)
    kfs = []
    for i in range(n):
        kf = cls_kf(kf_id=i, camera=cam, quat=[1, 0.02 * i, -0.01 * i, 0],
                    trans=[0.05 * i, 0, 0])
        img = rng.uniform(0.1, 0.9, (3, H, W)).astype(np.float32)
        img[:, :3, :5] = 0.0
        kf.image = img
        kfs.append(kf)
    return cam, kfs


@pytest.fixture(scope="module")
def trained_jax_state():
    """The JAX state after nine steps (densify statistics accumulated)."""
    jmc = JModelConfig(**SMALL)
    rng = np.random.default_rng(0)
    pts = rng.uniform([-0.8, -0.6, 1.5], [0.8, 0.6, 4.0], size=(40, 3))
    anchors, _ = j_insert_points(j_empty_state(jmc), pts, jmc)
    ts = j_init_train_state(anchors, init_decoders(jax.random.PRNGKey(0),
                                                   jmc), jmc)
    _, kfs = _keyframes(JCamera, JKeyframe, n=1)
    cam = {k: jnp.asarray(v) for k, v in kfs[0].render_inputs().items()}
    step = jax.jit(j_make_train_step(jmc, JOptConfig(**OPT),
                                     JRasterConfig(**RASTER), W, H,
                                     interpret=True))
    for _ in range(9):
        ts, _ = step(ts, cam, jnp.asarray(kfs[0].image), jnp.zeros(3))
    return ts


def test_adjust_anchor_matches_jax_with_injected_masks(trained_jax_state):
    jts = trained_jax_state
    jmc, joc = JModelConfig(**SMALL), JOptConfig(**OPT)
    mc, oc = ModelConfig(**SMALL), OptimizationConfig(**OPT)
    rng = jax.random.PRNGKey(3)
    ck = mc.capacity * mc.n_offsets
    keys = jax.random.split(rng, mc.update_depth)
    masks = [np.asarray(jax.random.uniform(keys[lv], (ck,)))
             <= keep_probability(lv) for lv in range(mc.update_depth)]
    ref = _flat(_tree(j_make_adjust(jmc, joc)(jts, rng)))

    ts = train_state_from_jax(_tree(jts))
    n0 = int(ts.anchors.num_active())
    ts = adjust_anchor(ts, [torch.tensor(m) for m in masks], mc, oc)
    ours = _flat(train_state_to_numpy(ts))
    assert ours.keys() == ref.keys()
    for name, val in ref.items():
        np.testing.assert_allclose(ours[name], val, rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    active = ours["anchors.active"]
    n1 = int(active.sum())
    assert n1 > n0  # anchors grew
    assert active[:n1].all() and not active[n1:].any()  # contiguous

    # the generator-driven entry: same invariants, finite state
    ts2 = train_state_from_jax(_tree(jts))
    ts2 = make_adjust_anchor(mc, oc)(ts2,
                                     torch.Generator().manual_seed(0))
    act = ts2.anchors.active.numpy()
    n2 = int(act.sum())
    assert act[:n2].all() and not act[n2:].any()
    for leaf in ts2.anchors.params().values():
        assert torch.isfinite(leaf).all()


def test_train_state_round_trip(trained_jax_state):
    tree = _tree(trained_jax_state)
    back = _flat(train_state_to_numpy(train_state_from_jax(tree)))
    ref = _flat(tree)
    assert back.keys() == ref.keys()
    for name, val in ref.items():
        np.testing.assert_array_equal(back[name], val, err_msg=name)
    # pose rows and their moments cross too
    rng = np.random.default_rng(5)
    for name in ("pose", "pose_ema"):
        tree[name] = rng.normal(size=(2, 6)).astype(np.float32)
    for m in ("mu", "nu"):
        tree["adam"][m]["pose"] = rng.normal(size=(2, 6)).astype(np.float32)
    back = _flat(train_state_to_numpy(train_state_from_jax(tree)))
    for name, val in _flat(tree).items():
        np.testing.assert_array_equal(back[name], val, err_msg=name)


def test_trainer_iterations_match_jax(tmp_path):
    """A few Trainer iterations from one state and seed: the same keyframes
    in the same order and the same losses; then the same similarity
    transform of the map, and a PLY that reads back."""
    jmc, joc, jrc = (JModelConfig(**SMALL), JOptConfig(**OPT),
                     JRasterConfig(**RASTER))
    mc, oc, rc = (ModelConfig(**SMALL), OptimizationConfig(**OPT),
                  RasterConfig(**RASTER))
    pts = np.random.default_rng(1).uniform([-0.8, -0.6, 1.5],
                                           [0.8, 0.6, 4.0], (40, 3))
    jt = JTrainer(jmc, joc, jrc, W, H, seed=2, interpret=True)
    tt = Trainer(mc, oc, rc, W, H, seed=2, device="cpu")
    for trainer, (cam_cls, kf_cls) in ((jt, (JCamera, JKeyframe)),
                                       (tt, (Camera, Keyframe))):
        _, kfs = _keyframes(cam_cls, kf_cls, n=3, seed=4)
        for kf in kfs:
            trainer.add_keyframe(kf)
    jt.initialize_map(pts)
    tt.initialize_map(pts, decoders=decoders_from_jax(
        flatten_params(jax.tree.map(np.asarray, jt.state.decoders))))
    assert tt.opt_config == OptimizationConfig(**dict(
        OPT, spatial_lr_scale=jt.opt_config.spatial_lr_scale))
    tt.state = train_state_from_jax(_tree(jt.state))

    for _ in range(4):
        jm, tm = jt.train_iteration(), tt.train_iteration()
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        assert int(tm["num_instances"]) == int(jm["num_instances"])
    assert tt.scene.kfs_used_times == jt.scene.kfs_used_times
    assert tt.iteration == jt.iteration == 4

    R = np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = [0.1, -0.2, 0.3]
    jt.apply_similarity(T, 1.5)
    tt.apply_similarity(T, 1.5)
    ja = _tree(jt.state.anchors)
    for name in ("anchor", "scaling", "offset", "rotation"):
        np.testing.assert_allclose(getattr(tt.state.anchors, name).numpy(),
                                   ja[name], rtol=1e-5, atol=1e-5,
                                   err_msg=name)

    metrics = tt.evaluate()
    assert metrics["n_keyframes"] == 3 and np.isfinite(metrics["psnr"])
    tt.save_ply(tmp_path / "map.ply")
    back = load_anchor_ply(tmp_path / "map.ply")
    n = int(tt.state.anchors.num_active())
    np.testing.assert_array_equal(back["offset"],
                                  tt.state.anchors.offset[:n].numpy())
    np.testing.assert_array_equal(back["feat"],
                                  tt.state.anchors.feat[:n].numpy())


def test_scene_sampler_matches_jax():
    j_cam, j_kfs = _keyframes(JCamera, JKeyframe, n=5)
    t_cam, t_kfs = _keyframes(Camera, Keyframe, n=5)
    js, ts = JScene(seed=7), Scene(seed=7)
    for scene, kfs in ((js, j_kfs), (ts, t_kfs)):
        for i, kf in enumerate(kfs):
            kf.remaining_times_of_use = 1 + i % 3
            scene.add_keyframe(kf)
    order_j = [js.sample_sliding_window_keyframe().kf_id for _ in range(30)]
    order_t = [ts.sample_sliding_window_keyframe().kf_id for _ in range(30)]
    assert order_t == order_j
    assert ts.nerfpp_norm_radius() == js.nerfpp_norm_radius()


def test_synthetic_scene_matches_jax():
    ours = synthetic.make_room_scene(300, seed=3)
    ref = jsynth.make_room_scene(300, seed=3)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    poses, ref_poses = synthetic.make_trajectory(3), jsynth.make_trajectory(3)
    for (q, t), (qr, tr) in zip(poses, ref_poses):
        np.testing.assert_allclose(q, qr, atol=1e-6)
        np.testing.assert_allclose(t, tr, atol=1e-12)
    cam = Camera(camera_id=0, width=W, height=H, fx=0.9 * W, fy=0.9 * W,
                 cx=W / 2, cy=H / 2)
    jcam = JCamera(camera_id=0, width=W, height=H, fx=0.9 * W, fy=0.9 * W,
                   cx=W / 2, cy=H / 2)
    _, imgs = synthetic.render_gt_views(*ours, poses, cam, device="cpu")
    _, ref_imgs = jsynth.render_gt_views(*ref, ref_poses, jcam,
                                         interpret=True)
    for a, b in zip(imgs, ref_imgs):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=0)
    assert max(float(np.ptp(a)) for a in imgs) > 0.1


def test_train_synthetic_app_on_cpu(tmp_path):
    ply = tmp_path / "out.ply"
    m = train_synthetic.main([
        "--iters", "12", "--views", "3", "--size", "32", "--gaussians",
        "300", "--capacity", "256", "--compact", "1024", "--nlarge", "64",
        "--seed-points", "120", "--log-every", "6", "--freq-reg",
        "--save-ply", str(ply), "--device", "cpu"])
    assert len(m["losses"]) == 12 and np.isfinite(m["losses"]).all()
    assert m["n_keyframes"] == 3
    assert np.isfinite([m["psnr"], m["ssim"], m["psnr_gs"]]).all()
    assert m["psnr"] > m["psnr_init"]
    assert load_anchor_ply(ply)["anchor"].shape[0] > 0


def test_train_step_matches_eager_jax_step(trained_jax_state):
    """One step with the depth and frequency terms both on, against the JAX
    step run eagerly (not jitted): every gradient (read from the first
    moments, active rows) within 2e-4 of its leaf's largest. JAX's own
    jitted step, which XLA compiles as one fused program, strays further
    from this eager one (tests/test_torch_train.py allows for that)."""
    jts = trained_jax_state
    opt = dict(OPT, lambda_depth=0.5, use_frequency_regularization=True,
               high_frequency_regularization_start=1)
    _, kfs = _keyframes(JCamera, JKeyframe, n=1)
    cam_np = kfs[0].render_inputs()
    gt = kfs[0].image
    gt_depth = np.random.default_rng(6).uniform(1.5, 3.5, (H, W)).astype(
        np.float32)
    j_step = j_make_train_step(JModelConfig(**SMALL), JOptConfig(**opt),
                               JRasterConfig(**RASTER), W, H, interpret=True)
    j_new, jm = j_step(jts, {k: jnp.asarray(v) for k, v in cam_np.items()},
                       jnp.asarray(gt), jnp.zeros(3), None,
                       jnp.asarray(gt_depth))
    state = _tree(jts)
    t_step = make_train_step(ModelConfig(**SMALL), OptimizationConfig(**opt),
                             RasterConfig(**RASTER), W, H)
    ts, tm = t_step(train_state_from_jax(state),
                    {k: torch.as_tensor(v) for k, v in cam_np.items()},
                    torch.tensor(gt), torch.zeros(3),
                    gt_depth=torch.tensor(gt_depth))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    old = _flat(state["adam"]["mu"])
    ref = _flat(_tree(j_new.adam.mu))
    ours = _flat(train_state_to_numpy(ts)["adam"]["mu"])
    active = state["anchors"]["active"]
    for name, r in ref.items():
        if name.startswith("pose"):
            continue
        g_ref = (r - 0.9 * old[name]) / 0.1
        g_ours = (ours[name] - 0.9 * old[name]) / 0.1
        if name.startswith("anchors."):
            g_ref, g_ours = g_ref[active], g_ours[active]
        scale = np.abs(g_ref).max() + 1e-12
        np.testing.assert_allclose(g_ours / scale, g_ref / scale, atol=2e-4,
                                   rtol=0, err_msg=name)
