"""The port's COLMAP path on the CPU against the JAX package: the binary
readers, the synthetic COLMAP maker (sparse model byte-equal, images within
one 8-bit level), a few Trainer iterations from the maker's scene (losses
within rtol 1e-4, as tests/test_torch_trainer.py holds them), and the
train_colmap app end to end with every --out file.
"""

import jax
import numpy as np
import pytest
import torch

from segs_slam_tpu.core import Camera as JCamera
from segs_slam_tpu.core.keyframe import Keyframe as JKeyframe
from segs_slam_tpu.io import colmap as jcolmap
from segs_slam_tpu.models.config import ModelConfig as JModelConfig
from segs_slam_tpu.ops.rasterizer import RasterConfig as JRasterConfig
from segs_slam_tpu.train.config import OptimizationConfig as JOptConfig
from segs_slam_tpu.train.trainer import Trainer as JTrainer
from segs_slam_tpu.utils import make_colmap_dataset as jmaker
from segs_slam_tpu_torch.apps import train_colmap
from segs_slam_tpu_torch.core import Camera, Keyframe
from segs_slam_tpu_torch.io import checkpoint, colmap
from segs_slam_tpu_torch.io.convert import (
    decoders_from_jax,
    flatten_params,
    train_state_from_jax,
)
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from segs_slam_tpu_torch.train.config import OptimizationConfig
from segs_slam_tpu_torch.train.trainer import Trainer
from segs_slam_tpu_torch.utils import make_colmap_dataset as maker
from test_io import _write_colmap_fixture
from test_torch_trainer import _tree
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

W, H = 64, 48
MAKER_ARGS = ["--views", "4", "--width", str(W), "--height", str(H),
              "--gaussians", "300", "--sparse-points", "120"]


def test_colmap_binary_readers(tmp_path):
    """tests/test_io.py::test_colmap_binary_readers on the port's copy, and
    every field equal to the JAX readers'."""
    _write_colmap_fixture(tmp_path)
    cams = colmap.read_cameras_binary(tmp_path / "cameras.bin")
    assert cams[1].model == "PINHOLE"
    assert cams[1].focal_and_center() == (60.0, 61.0, 32.0, 24.0)
    imgs = colmap.read_images_binary(tmp_path / "images.bin")
    img = imgs[7]
    assert img.name == "img0.png"
    np.testing.assert_allclose(img.qvec, [1, 0, 0, 0])
    np.testing.assert_allclose(img.xys, [[1, 2], [3, 4]])
    assert list(img.point3d_ids) == [11, -1]
    xyz, rgb = colmap.read_points3d_binary(tmp_path / "points3D.bin")
    np.testing.assert_allclose(xyz, [[1, 2, 3], [-1, 0, 5]])
    assert rgb[0, 0] == 255

    ref_img = jcolmap.read_images_binary(tmp_path / "images.bin")[7]
    for field in ("qvec", "tvec", "xys", "point3d_ids"):
        np.testing.assert_array_equal(getattr(img, field),
                                      getattr(ref_img, field))
    ref_cam = jcolmap.read_cameras_binary(tmp_path / "cameras.bin")[1]
    assert (cams[1].model, cams[1].width, cams[1].height) == (
        ref_cam.model, ref_cam.width, ref_cam.height)
    np.testing.assert_array_equal(cams[1].params, ref_cam.params)
    for a, b in zip((xyz, rgb), jcolmap.read_points3d_binary(
            tmp_path / "points3D.bin")):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The same 4-view 64x48 scene written by both packages' makers."""
    root = tmp_path_factory.mktemp("colmap")
    jmaker.main(["--out", str(root / "jax")] + MAKER_ARGS)
    maker.main(["--out", str(root / "port"), "--device", "cpu"] + MAKER_ARGS)
    return root / "jax", root / "port"


def test_colmap_maker_matches_jax(scenes):
    """cameras.bin, images.bin and points3D.bin byte-equal; every PNG within
    one 8-bit level of the JAX maker's (the renders agree within 2e-4)."""
    from PIL import Image

    ref, ours = scenes
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (ours / "sparse/0" / name).read_bytes() == \
            (ref / "sparse/0" / name).read_bytes(), name
    names = sorted(p.name for p in (ref / "images").iterdir())
    assert names == sorted(p.name for p in (ours / "images").iterdir())
    assert len(names) == 4
    for n in names:
        a = np.asarray(Image.open(ours / "images" / n), np.int16)
        b = np.asarray(Image.open(ref / "images" / n), np.int16)
        assert a.shape == (H, W, 3) and a.max() > 10
        assert np.abs(a - b).max() <= 1, n
    scene = colmap.read_scene(ours / "sparse/0")
    assert len(scene.images) == 4 and scene.points_xyz.shape == (120, 3)


SMALL = dict(feat_dim=8, n_offsets=4, appearance_dim=8, embedding_dim=4,
             capacity=256, voxel_size=0.05)
OPT = dict(start_stat=2, update_from=4, update_interval=5, update_until=100,
           use_frequency_regularization=False)
RASTER = dict(tile=16, compact=1024, kmax=16, chunk=64)


def _keyframes(scene_dir, cam_cls, kf_cls):
    """train_colmap's keyframes: the model's camera and each image's pose,
    the PNGs as float32 HWC."""
    from PIL import Image

    scene = jcolmap.read_scene(scene_dir / "sparse/0")
    c = scene.cameras[1]
    fx, fy, cx, cy = c.focal_and_center()
    cam = cam_cls(camera_id=c.camera_id, width=c.width, height=c.height,
                  fx=fx, fy=fy, cx=cx, cy=cy)
    kfs = []
    for img in scene.images.values():
        arr = np.asarray(Image.open(scene_dir / "images" / img.name)
                         .convert("RGB"), np.float32) / 255.0
        kfs.append(kf_cls(kf_id=img.image_id, camera=cam, quat=img.qvec,
                          trans=img.tvec, image=arr))
    return cam, kfs, scene.points_xyz


def test_trainer_on_colmap_scene_matches_jax(scenes):
    """Four Trainer iterations on the JAX maker's scene, from one state and
    seed: the same keyframes in the same order, losses within rtol 1e-4,
    the same instance counts."""
    ref, _ = scenes
    jt = JTrainer(JModelConfig(**SMALL), JOptConfig(**OPT),
                  JRasterConfig(**RASTER), W, H, seed=2, interpret=True)
    tt = Trainer(ModelConfig(**SMALL), OptimizationConfig(**OPT),
                 RasterConfig(**RASTER), W, H, seed=2, device="cpu")
    for trainer, classes in ((jt, (JCamera, JKeyframe)),
                             (tt, (Camera, Keyframe))):
        cam, kfs, pts = _keyframes(ref, *classes)
        trainer.scene.add_camera(cam)
        for kf in kfs:
            trainer.add_keyframe(kf)
    jt.initialize_map(pts)
    n = tt.initialize_map(pts, decoders=decoders_from_jax(
        flatten_params(jax.tree.map(np.asarray, jt.state.decoders))))
    assert n > 20
    tt.state = train_state_from_jax(_tree(jt.state))
    for _ in range(4):
        jm, tm = jt.train_iteration(), tt.train_iteration()
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        assert int(tm["num_instances"]) == int(jm["num_instances"]) > 0
    assert tt.scene.kfs_used_times == jt.scene.kfs_used_times


def test_train_colmap_end_to_end(scenes, tmp_path):
    """train_colmap on the port's scene with --device cpu: it trains, the
    evaluation is finite, and --out writes the JAX app's files; the train
    state reloads with the same parameters."""
    _, ours = scenes
    out = tmp_path / "out"
    res = train_colmap.main([
        "--scene", str(ours), "--iters", "6", "--capacity", "512",
        "--compact", "2048", "--nlarge", "256", "--log-every", "3",
        "--out", str(out), "--device", "cpu"])
    assert res["iterations"] == 6 and res["n_keyframes"] == 4
    assert np.isfinite(res["psnr"]) and np.isfinite(res["ms_per_iter"])
    t = res["trainer"]
    assert not t.raster_config.packed_train
    for name in ("anchors.ply", "ckpt", "cameras.json", "cfg_args",
                 "mlps/mlp_opacity_l1_weight.txt"):
        assert (out / name).exists(), name
    back = checkpoint.load_train_state(out / "ckpt")
    assert back.step == t.state.step
    for name in ("anchor", "feat", "offset", "scaling"):
        assert torch.equal(getattr(back.anchors, name),
                           getattr(t.state.anchors, name)), name
