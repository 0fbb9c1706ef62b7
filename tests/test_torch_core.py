"""Parity of the port's core modules (camera, keyframe, se3) with the JAX
package, and the port's freedom from JAX."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segs_slam_tpu.core import Camera as JCamera
from segs_slam_tpu.core import se3 as jse3
from segs_slam_tpu.core.keyframe import Keyframe as JKeyframe
from segs_slam_tpu_torch.core import Camera, Keyframe, se3


def _random_pose(rng):
    q = rng.normal(size=4)
    return q / np.linalg.norm(q), rng.normal(size=3)


def test_keyframe_render_inputs_match_jax_package():
    rng = np.random.default_rng(0)
    cam_args = dict(camera_id=0, width=64, height=48, fx=60.0, fy=55.0,
                    cx=32.0, cy=24.0)
    for i in range(3):
        q, t = _random_pose(rng)
        ours = Keyframe(kf_id=i, camera=Camera(**cam_args), quat=q, trans=t)
        ref = JKeyframe(kf_id=i, camera=JCamera(**cam_args), quat=q, trans=t)
        a, b = ours.render_inputs(), ref.render_inputs()
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def _quats(rng, n=8):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _rotmats(rng):
    """Rotations that exercise every branch of rotmat_to_quat (trace > 0
    and each diagonal-dominant case)."""
    out = [np.eye(3, dtype=np.float32)]
    for axis in range(3):
        ang = np.pi * 0.9
        c, s = np.cos(ang), np.sin(ang)
        R = np.eye(3)
        i, j = [a for a in range(3) if a != axis]
        R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
        out.append(R.astype(np.float32))
    out += [np.asarray(jse3.quat_to_rotmat(jnp.asarray(q)))
            for q in _quats(rng, 4)]
    return out


SE3_CASES = ["quat_to_rotmat", "normalize_quat", "quat_mul", "rotmat_to_quat",
             "se3_matrix", "se3_inverse", "transform_points",
             "scale_and_transform_points"]


@pytest.mark.parametrize("name", SE3_CASES)
def test_se3_matches_jax(name):
    rng = np.random.default_rng(SE3_CASES.index(name))
    q = _quats(rng)
    t = rng.normal(size=(8, 3)).astype(np.float32)
    pts = rng.normal(size=(16, 3)).astype(np.float32)
    T = np.asarray(jse3.se3_matrix(jnp.asarray(q[0]), jnp.asarray(t[0])))
    if name == "quat_to_rotmat":
        cases = [(q,)]
    elif name == "normalize_quat":
        cases = [(q * 3.0,)]
    elif name == "quat_mul":
        cases = [(q, _quats(rng))]
    elif name == "rotmat_to_quat":
        cases = [(R,) for R in _rotmats(rng)]
    elif name == "se3_matrix":
        cases = [(q, t), (q[0], t[0])]
    elif name == "se3_inverse":
        cases = [(T,)]
    elif name == "transform_points":
        cases = [(T, pts)]
    else:
        cases = [(T, np.float32(1.7), pts)]
    for args in cases:
        ref = np.asarray(getattr(jse3, name)(*(jnp.asarray(a) for a in args)))
        ours = getattr(se3, name)(*(torch.tensor(np.asarray(a))
                                    for a in args))
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0)


TRAINING_SLICE = (
    "ops.rasterizer.dense", "train.config", "train.densify", "train.losses",
    "train.optimizer", "train.schedules", "train.step", "train.trainer",
    "slam.scene", "io.ply", "utils.synthetic", "apps.train_synthetic")
EVAL_SLICE = ("eval", "eval.metrics", "eval.recorder", "eval.harness",
              "models.renderer", "ops.rasterizer.binning",
              "apps.render_views")
SLAM_SLICE = ("slam.protocol", "slam.frontends", "slam.producers",
              "slam.mapper", "io.checkpoint", "io.config_yaml",
              "io.datasets", "core.undistort", "apps.common",
              "apps.slam_rgbd", "utils.make_rgbd_dataset")


def test_port_imports_no_jax():
    """Importing every module of the port, the training, eval and SLAM
    slices' included, leaves JAX out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import segs_slam_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'segs_slam_tpu.')) or "
        "m == 'segs_slam_tpu')\n"
        "need = {'segs_slam_tpu_torch.' + n for n in (%r)}\n"
        "missing = sorted(need - set(names))\n"
        "print(len(names), bad, missing)\n"
        "sys.exit(1 if bad or missing or len(names) < 56 else 0)\n"
    ) % (TRAINING_SLICE + EVAL_SLICE + SLAM_SLICE,)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0, res.stdout + res.stderr
