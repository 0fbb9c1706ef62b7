"""The port's Gaussian-pyramid levels against the JAX package on the CPU:
the level sizes, the sequence of levels trained and the losses of a few
pyramid iterations from one state (rtol 1e-4, tests/test_torch_trainer.py's
Trainer tolerance)."""

import jax
import numpy as np

from segs_slam_tpu.core import Camera as JCamera
from segs_slam_tpu.core.keyframe import Keyframe as JKeyframe
from segs_slam_tpu.models.config import ModelConfig as JModelConfig
from segs_slam_tpu.ops.rasterizer import RasterConfig as JRasterConfig
from segs_slam_tpu.train.config import OptimizationConfig as JOptConfig
from segs_slam_tpu.train.trainer import Trainer as JTrainer
from segs_slam_tpu_torch.core import Camera, Keyframe
from segs_slam_tpu_torch.io.convert import (
    decoders_from_jax,
    flatten_params,
    train_state_from_jax,
)
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from segs_slam_tpu_torch.train.config import OptimizationConfig
from segs_slam_tpu_torch.train.trainer import Trainer
from test_torch_pose import PTS
from test_torch_trainer import OPT, RASTER, SMALL, _tree
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)


PW, PH = 64, 48


def _pyramid_keyframes(cam_cls, kf_cls, n=3, seed=6):
    rng = np.random.default_rng(seed)
    cam = cam_cls(camera_id=0, width=PW, height=PH, fx=50.0, fy=50.0,
                  cx=PW / 2, cy=PH / 2)
    kfs = []
    for i in range(n):
        kf = kf_cls(kf_id=i, camera=cam, quat=[1, 0.01 * i, 0, 0],
                    trans=[0.05 * i, 0, 0])
        img = rng.uniform(0.1, 0.9, (3, PH, PW)).astype(np.float32)
        img[:, :5, :7] = 0.0
        kf.image = img
        kfs.append(kf)
    return kfs


def test_pyramid_levels_match_jax():
    """Two sub-levels with one use each: the level sizes, the sequence of
    levels trained and the losses of ten iterations (three at 16x16, three
    at 32x16, then full resolution) from one state. Densification is
    kept out of the ten (its keep-masks are random draws that differ
    between the packages; tests/test_torch_trainer.py compares it with
    JAX's masks injected)."""
    opt = dict(OPT, update_from=1000, update_until=2000)
    jmc, joc, jrc = (JModelConfig(**SMALL), JOptConfig(**opt),
                     JRasterConfig(**RASTER))
    kw = dict(num_pyramid_sub_levels=2, pyramid_times_of_use=1, seed=3)
    jt = JTrainer(jmc, joc, jrc, PW, PH, interpret=True, **kw)
    tt = Trainer(ModelConfig(**SMALL), OptimizationConfig(**opt),
                 RasterConfig(**RASTER), PW, PH, device="cpu", **kw)
    assert tt._level_sizes == jt._level_sizes == [(16, 16), (32, 16),
                                                  (64, 48)]
    for trainer, classes in ((jt, (JCamera, JKeyframe)),
                             (tt, (Camera, Keyframe))):
        for kf in _pyramid_keyframes(*classes):
            trainer.add_keyframe(kf)
    jt.initialize_map(PTS)
    tt.initialize_map(PTS, decoders=decoders_from_jax(
        flatten_params(jax.tree.map(np.asarray, jt.state.decoders))))
    tt.state = train_state_from_jax(_tree(jt.state))
    for kid in range(3):
        _, gj = jt._kf_inputs(jt.scene.keyframes[kid], 0)
        _, gt = tt._kf_inputs(tt.scene.keyframes[kid], 0)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-6)
    levels = {"j": [], "t": []}
    for _ in range(10):
        jm, tm = jt.train_iteration(), tt.train_iteration()
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        for key, tr in (("j", jt), ("t", tt)):
            levels[key].append([list(kf.gaus_pyramid_times_of_use)
                                for _, kf in sorted(tr.scene.keyframes
                                                    .items())])
    assert levels["t"] == levels["j"]
    assert tt.scene.kfs_used_times == jt.scene.kfs_used_times
    assert set(tt._steps) == {(16, 16), (32, 16), (64, 48)}
