"""The port's photometric keyframe-pose refinement against the JAX package
on the CPU (Trainer.refine_keyframe_pose, through render, K1/K2's plain
versions and the port's project), and tests/test_pose_refine.py's recovery
test on the port.

Tolerance: refined poses within 1e-4 (two descent steps of normalised
gradients, whose direction carries the blend backward's summation order).
"""

import numpy as np
import pytest
import torch

from segs_slam_tpu_torch.core import Camera, se3
from segs_slam_tpu_torch.io.convert import train_state_from_jax
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from segs_slam_tpu_torch.train.config import OptimizationConfig
from segs_slam_tpu_torch.train.trainer import Trainer
from segs_slam_tpu_torch.utils.synthetic import (
    make_room_scene,
    make_trajectory,
    render_gt_views,
)
from test_torch_pose import _pose_trainers
from test_torch_trainer import H, W, _tree
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)


def _perturb(kf, ang_deg=1.0, dt=(0.02, -0.015, 0.01)):
    """kf's pose rotated by ang_deg about the view axis and shifted by dt
    (tests/test_pose_refine.py's perturbation)."""
    ang = np.deg2rad(ang_deg)
    dR = np.array([[np.cos(ang), -np.sin(ang), 0],
                   [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    Rn = dR @ kf.rotation_matrix()
    qn = se3.rotmat_to_quat(torch.as_tensor(Rn, dtype=torch.float32)).numpy()
    return qn, dR @ kf.trans + np.asarray(dt)


@pytest.mark.parametrize("pool", [1, 4])
def test_refine_keyframe_pose_matches_jax(pool):
    """Two refinement steps of a perturbed keyframe (with a depth plane)
    from one state: the refined pose within 1e-4 and the improvement
    within rtol 1e-3."""
    jt, tt = _pose_trainers(optimize_poses=False)
    for _ in range(6):
        jt.train_iteration()
    tt.state = train_state_from_jax(_tree(jt.state))
    depth = np.random.default_rng(5).uniform(1.5, 3.0, (H, W)).astype(
        np.float32)
    for trainer in (jt, tt):
        kf = trainer.scene.keyframes[1]
        q, t = _perturb(kf)
        kf.set_pose(q, t)
        kf.depth = depth
        trainer._cam_cache.pop(1, None)
    gain_j = jt.refine_keyframe_pose(jt.scene.keyframes[1], steps=2,
                                     pool=pool)
    gain_t = tt.refine_keyframe_pose(tt.scene.keyframes[1], steps=2,
                                     pool=pool)
    kj, kt = jt.scene.keyframes[1], tt.scene.keyframes[1]
    assert gain_j > 0
    np.testing.assert_allclose(gain_t, gain_j, rtol=1e-3)
    np.testing.assert_allclose(kt.quat, kj.quat, atol=1e-4)
    np.testing.assert_allclose(kt.trans, kj.trans, atol=1e-4)


def test_pose_refinement_recovers_perturbation():
    """tests/test_pose_refine.py on the port: a keyframe perturbed by 1.5
    degrees and ~3 cm recovers toward its true pose against a map trained
    for 300 iterations."""
    cam = Camera(camera_id=0, width=96, height=96, fx=86, fy=86, cx=48,
                 cy=48)
    means, scales, quats, opac, colors = make_room_scene(1200)
    kfs, _ = render_gt_views(means, scales, quats, opac, colors,
                             make_trajectory(6), cam, device="cpu")
    mc = ModelConfig(capacity=4096, n_offsets=4, feat_dim=16,
                     appearance_dim=8, embedding_dim=4, voxel_size=0.03)
    tr = Trainer(mc, OptimizationConfig(use_frequency_regularization=False),
                 RasterConfig(tile=16, compact=8192, kmax=8, chunk=128),
                 width=96, height=96, device="cpu")
    tr.scene.add_camera(cam)
    for kf in kfs:
        tr.add_keyframe(kf)
    rng = np.random.default_rng(0)
    tr.initialize_map(means[rng.choice(len(means), 800, replace=False)])
    tr.train(300)

    kf = kfs[2]
    q0, t0 = kf.quat.copy(), kf.trans.copy()
    kf.set_pose(*_perturb(kf, 1.5))
    tr._cam_cache.pop(kf.kf_id, None)
    err0 = np.linalg.norm(kf.trans - t0)
    for _ in range(6):
        tr.refine_keyframe_pose(kf, steps=5, lr=4e-3)
    err1 = np.linalg.norm(kf.trans - t0)
    dq = min(np.linalg.norm(kf.quat - q0), np.linalg.norm(kf.quat + q0))
    assert err1 < 0.6 * err0, (err0, err1)
    assert dq < 0.01, dq
