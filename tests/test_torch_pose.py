"""The port's pose rows against the JAX package on the CPU: apply_pose_delta,
a train step with pose rows in each optimiser family and prior mode (and
the pose_opt_start gate), and the Trainer's pose-row bookkeeping
(set_keyframe_pose, fold_pose_deltas). tests/test_torch_pose_refine.py
holds photometric pose refinement, tests/test_torch_pyramid.py the
Gaussian-pyramid levels.

Tolerances: f32 rounding of the same formulas for the pose algebra (atol
1e-6); a step's loss within rtol 1e-4 and its gradients within 2e-4 of each
leaf's largest (tests/test_torch_train.py says why).
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
from segs_slam_tpu.train.config import OptimizationConfig as JOptConfig
from segs_slam_tpu.train.step import apply_pose_delta as j_apply_pose_delta
from segs_slam_tpu.train.step import init_train_state as j_init_train_state
from segs_slam_tpu.train.step import make_train_step as j_make_train_step
from segs_slam_tpu.train.trainer import Trainer as JTrainer
from segs_slam_tpu_torch.core import Camera, Keyframe
from segs_slam_tpu_torch.io.convert import (
    decoders_from_jax,
    flatten_params,
    train_state_from_jax,
    train_state_to_numpy,
)
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from segs_slam_tpu_torch.train.config import OptimizationConfig
from segs_slam_tpu_torch.train.step import apply_pose_delta, make_train_step
from segs_slam_tpu_torch.train.trainer import Trainer
from test_torch_trainer import OPT, RASTER, SMALL, W, H, _flat, _keyframes
from test_torch_trainer import _tree
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

PTS = np.random.default_rng(1).uniform([-0.8, -0.6, 1.5], [0.8, 0.6, 4.0],
                                       (40, 3))


def _cam_dict(kf, lib):
    return {k: lib.asarray(v) if lib is jnp else torch.as_tensor(v)
            for k, v in kf.render_inputs().items()}


def test_apply_pose_delta_matches_jax():
    _, kfs = _keyframes(JCamera, JKeyframe, n=2)
    rng = np.random.default_rng(0)
    deltas = [np.zeros(6, np.float32),
              rng.normal(scale=0.02, size=6).astype(np.float32),
              rng.normal(scale=0.5, size=6).astype(np.float32)]
    for kf in kfs:
        for d in deltas:
            ref = j_apply_pose_delta(_cam_dict(kf, jnp), jnp.asarray(d))
            ours = apply_pose_delta(_cam_dict(kf, torch), torch.tensor(d))
            assert ours.keys() == ref.keys()
            for k in ref:
                np.testing.assert_allclose(ours[k].numpy(),
                                           np.asarray(ref[k]), atol=1e-6,
                                           rtol=0, err_msg=k)
    # the smooth norm: a finite gradient at delta = 0
    d = torch.zeros(6, requires_grad=True)
    c = apply_pose_delta(_cam_dict(kfs[0], torch), d)
    (g,) = torch.autograd.grad(c["full_proj_transform"].sum()
                               + c["camera_center"].sum(), d)
    assert torch.isfinite(g).all() and g.abs().max() > 0


POSE_CASES = [
    ("adam_base_gated", dict(pose_opt_mode="adam", pose_prior_mode="base",
                             pose_opt_start=2)),
    ("sgd_ema", dict(pose_opt_mode="sgd", pose_prior_mode="ema",
                     pose_lr_init=1e-2)),
    ("amsmax_base", dict(pose_opt_mode="amsmax", pose_prior_mode="base")),
]


@pytest.mark.parametrize("case,pose_kw", POSE_CASES)
def test_pose_row_step_matches_jax(case, pose_kw):
    """Two steps on keyframe row 1 of a 3-row table, each from the JAX
    state of the step before, against the JAX step run eagerly (its jitted
    form rounds the composed camera otherwise and flips a few alpha tests
    once the delta is not zero): the loss, the pose table, its EMA and the
    step's gradients of every leaf. With pose_opt_start 2 the row holds
    still in the first step."""
    jmc = JModelConfig(**SMALL)
    anchors, _ = j_insert_points(j_empty_state(jmc), PTS, jmc)
    jts = j_init_train_state(anchors, init_decoders(jax.random.PRNGKey(0),
                                                    jmc), jmc,
                             max_pose_kfs=3)
    rng = np.random.default_rng(2)
    jts = jts._replace(
        pose=jnp.asarray(rng.normal(scale=0.01, size=(3, 6)), jnp.float32),
        pose_ema=jnp.asarray(rng.normal(scale=0.01, size=(3, 6)),
                             jnp.float32))
    opt = dict(OPT, **pose_kw)
    _, kfs = _keyframes(JCamera, JKeyframe, n=1)
    cam_np = kfs[0].render_inputs()
    gt = kfs[0].image
    j_step = j_make_train_step(jmc, JOptConfig(**opt),
                               JRasterConfig(**RASTER), W, H, interpret=True)
    t_step = make_train_step(ModelConfig(**SMALL), OptimizationConfig(**opt),
                             RasterConfig(**RASTER), W, H)
    moved = []
    for i in range(2):
        state = _tree(jts)
        jts, jm = j_step(jts, {k: jnp.asarray(v) for k, v in cam_np.items()},
                         jnp.asarray(gt), jnp.zeros(3), jnp.int32(1))
        ts, tm = t_step(train_state_from_jax(state),
                        {k: torch.as_tensor(v) for k, v in cam_np.items()},
                        torch.tensor(gt), torch.zeros(3), kf_row=1)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        new, ours = _tree(jts), train_state_to_numpy(ts)
        for name in ("pose", "pose_ema"):
            scale = np.abs(new[name]).max()
            np.testing.assert_allclose(ours[name] / scale, new[name] / scale,
                                       atol=2e-4, rtol=0,
                                       err_msg=f"step {i} {name}")
        # rows other than 1 never move
        np.testing.assert_array_equal(ours["pose"][[0, 2]],
                                      state["pose"][[0, 2]])
        moved.append(not np.array_equal(ours["pose"][1], state["pose"][1]))
        old = _flat(state["adam"]["mu"])
        ref_mu = _flat(new["adam"]["mu"])
        our_mu = _flat(ours["adam"]["mu"])
        active = state["anchors"]["active"]
        for name, r in ref_mu.items():
            g_ref = (r - 0.9 * old[name]) / 0.1
            g_ours = (our_mu[name] - 0.9 * old[name]) / 0.1
            if name.startswith("anchors."):
                g_ref, g_ours = g_ref[active], g_ours[active]
            if name == "pose":  # the masked rows keep their moments
                g_ref, g_ours = g_ref[1:2], g_ours[1:2]
            scale = np.abs(g_ref).max() + 1e-12
            np.testing.assert_allclose(g_ours / scale, g_ref / scale,
                                       atol=2e-4, rtol=0,
                                       err_msg=f"step {i} grad {name}")
    gate = pose_kw.get("pose_opt_start", 0)
    assert moved == [i + 1 >= gate for i in range(2)]


def _pose_trainers(optimize_poses=True, n=3, seed=2):
    """A JAX and a port Trainer with the same keyframes, map and state."""
    jmc, joc, jrc = (JModelConfig(**SMALL), JOptConfig(**OPT),
                     JRasterConfig(**RASTER))
    jt = JTrainer(jmc, joc, jrc, W, H, seed=seed, interpret=True,
                  optimize_poses=optimize_poses, max_pose_kfs=4)
    tt = Trainer(ModelConfig(**SMALL), OptimizationConfig(**OPT),
                 RasterConfig(**RASTER), W, H, seed=seed, device="cpu",
                 optimize_poses=optimize_poses, max_pose_kfs=4)
    for trainer, classes in ((jt, (JCamera, JKeyframe)),
                             (tt, (Camera, Keyframe))):
        for kf in _keyframes(*classes, n=n, seed=4)[1]:
            trainer.add_keyframe(kf)
    jt.initialize_map(PTS)
    tt.initialize_map(PTS, decoders=decoders_from_jax(
        flatten_params(jax.tree.map(np.asarray, jt.state.decoders))))
    tt.state = train_state_from_jax(_tree(jt.state))
    return jt, tt


def test_set_keyframe_pose_resets_row_and_moments():
    _, tt = _pose_trainers()
    assert tt._pose_rows == {0: 0, 1: 1, 2: 2}
    st = tt.state
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for x in (st.pose, st.pose_ema, st.adam.mu["pose"],
                  st.adam.nu["pose"]):
            x.copy_(torch.rand(x.shape, generator=g) + 0.1)
    before = [x.clone() for x in (st.pose, st.pose_ema, st.adam.mu["pose"],
                                  st.adam.nu["pose"])]
    kf = tt.scene.keyframes[1]
    tt.set_keyframe_pose(kf, [1.0, 0.0, 0.0, 0.0], [0.3, 0.1, -0.2])
    np.testing.assert_array_equal(kf.trans, [0.3, 0.1, -0.2])
    for x, b in zip((st.pose, st.pose_ema, st.adam.mu["pose"],
                     st.adam.nu["pose"]), before):
        assert not x[1].any()
        assert torch.equal(x[[0, 2, 3]], b[[0, 2, 3]])
    assert tt.pose_delta_np(1) is None
    assert tt.pose_delta_np(0) is not None


def test_fold_pose_deltas_matches_jax():
    rng = np.random.default_rng(4)
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.normal(size=3)
        d = rng.normal(scale=0.05, size=6).astype(np.float32)
        qj, tj = JTrainer._fold_delta_np(q, t, d)
        qt, tt_ = Trainer._fold_delta_np(q, t, d)
        np.testing.assert_allclose(qt, qj, atol=1e-6, rtol=0)
        np.testing.assert_allclose(tt_, tj, atol=1e-12, rtol=0)

    jt, tt = _pose_trainers()
    table = rng.normal(scale=0.02, size=(4, 6)).astype(np.float32)
    table[2] = 0.0  # a zero row is not folded
    jt.state = jt.state._replace(pose=jnp.asarray(table))
    tt.state.pose.copy_(torch.tensor(table))
    cam_j = np.asarray(jt.refined_cam(jt.scene.keyframes[0])[
        "world_view_transform"])
    cam_t = tt.refined_cam(tt.scene.keyframes[0])["world_view_transform"]
    np.testing.assert_allclose(cam_t.numpy(), cam_j, atol=1e-6)
    assert jt.fold_pose_deltas() == tt.fold_pose_deltas() == 2
    for kid, kf in tt.scene.keyframes.items():
        jkf = jt.scene.keyframes[kid]
        np.testing.assert_allclose(kf.quat, jkf.quat, atol=1e-6)
        np.testing.assert_allclose(kf.trans, jkf.trans, atol=1e-7)
    assert not tt.state.pose.any() and not tt.state.adam.mu["pose"].any()
    # the folded pose renders where base + delta rendered
    np.testing.assert_allclose(
        tt._kf_inputs(tt.scene.keyframes[0])[0]["world_view_transform"]
        .numpy(), cam_t.numpy(), atol=1e-5)
