"""The port's SLAM support modules and the slam_rgbd app on the CPU.

Against the JAX package: the numpy copies (frontends, producers, protocol
streams, the YAML ingest, the apps' config resolution) give the same values;
the synthetic RGB-D maker's arrays before encoding within 2e-4 of the JAX
maker's renders (the blend tolerance of tests/test_rasterizer.py); the
Replica loader's poses equal; the MLP text dumps and cameras.json equal
byte for byte for the same weights and keyframes. Then slam_rgbd end to end
on a tiny sequence: every output file written and, with the pose oracle,
an ATE below 1e-5 m.
"""

import argparse
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segs_slam_tpu.apps import common as jcommon
from segs_slam_tpu.core.camera import Camera as JCamera
from segs_slam_tpu.core.keyframe import Keyframe as JKeyframe
from segs_slam_tpu.io import checkpoint as jckpt
from segs_slam_tpu.io import config_yaml as jyaml
from segs_slam_tpu.io import datasets as jdatasets
from segs_slam_tpu.models.config import ModelConfig as JModelConfig
from segs_slam_tpu.models.decoders import init_decoders
from segs_slam_tpu.ops.rasterizer import RasterConfig as JRasterConfig
from segs_slam_tpu.ops.rasterizer import rasterize as j_rasterize
from segs_slam_tpu.slam import frontends as jfrontends
from segs_slam_tpu.slam import producers as jproducers
from segs_slam_tpu.slam import protocol as jprotocol
from segs_slam_tpu_torch.apps import common, slam_rgbd
from segs_slam_tpu_torch.core import Camera, Keyframe, se3
from segs_slam_tpu_torch.eval import harness
from segs_slam_tpu_torch.io import checkpoint, config_yaml, datasets
from segs_slam_tpu_torch.io.convert import decoders_from_jax, flatten_params
from segs_slam_tpu_torch.ops.rasterizer import blend as tblend
from segs_slam_tpu_torch.slam import frontends, producers, protocol
from segs_slam_tpu_torch.utils import make_rgbd_dataset as maker
from test_app_config import REF  # the reference's cfg/gaussian_mapper

SEQ_W, SEQ_H = 64, 48


def test_backproject_depth_matches_jax():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 4.0, (48, 64)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.2] = 0.0
    q = np.array([0.97, 0.1, -0.2, 0.05])
    q /= np.linalg.norm(q)
    t = np.array([0.3, -0.1, 0.2])
    args = dict(fx=50.0, fy=52.0, cx=31.5, cy=23.5, width=64, height=48)
    for stride in (1, 8):
        ref = jfrontends.backproject_depth(
            depth, JCamera(camera_id=0, **args), q, t, 0.05, 3.0,
            stride=stride)
        ours = frontends.backproject_depth(
            depth, Camera(camera_id=0, **args), q, t, 0.05, 3.0,
            stride=stride)
        assert len(ours) > 0
        np.testing.assert_array_equal(ours, ref)


def test_tracker_pose_updates_and_similarity_match_jax():
    fed = [0, 10, 20, 30]
    poses = np.random.default_rng(1).normal(size=(4, 7))
    ref = jproducers.tracker_pose_updates(fed, [0, 3, 9, 1], poses)
    ours = producers.tracker_pose_updates(fed, [0, 3, 9, 1], poses)
    assert ours.keys() == ref.keys()
    for k in ref:
        for a, b in zip(ours[k], ref[k]):
            np.testing.assert_array_equal(a, b)
    src = np.random.default_rng(2).normal(size=(8, 3))
    s, T = producers.fit_similarity(src, 1.3 * src + 0.2)
    sj, Tj = jproducers.fit_similarity(src, 1.3 * src + 0.2)
    assert s == sj
    np.testing.assert_array_equal(T, Tj)


def test_record_replay_stream_matches_jax(tmp_path):
    """A stream recorded through the port reads back with the same payload
    as the same stream recorded through the JAX package."""
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(8, 8, 3)).astype(np.float32)
    pts = rng.normal(size=(30, 3))
    streams = {}
    for name, proto in (("jax", jprotocol), ("port", protocol)):
        ops = [proto.MappingOperation(
            kind=proto.OperationKind.LOCAL_MAPPING_BA,
            keyframes=[proto.KeyframeData(
                kf_id=4, camera_id=0, quat=np.array([1.0, 0, 0, 0]),
                trans=np.zeros(3), image=img, timestamp=4.0)],
            points_xyz=pts, point_ids=np.arange(30)),
            proto.MappingOperation(kind=proto.OperationKind.SCALE_REFINEMENT,
                                   scale=1.5, transform=np.eye(4))]
        path = tmp_path / f"{name}.pkl"
        proto.record_stream(ops, path)
        streams[name] = list(proto.replay_stream(path))
    for a, b in zip(streams["port"], streams["jax"], strict=True):
        assert int(a.kind) == int(b.kind) and a.scale == b.scale
        assert len(a.keyframes) == len(b.keyframes)
        for ka, kb in zip(a.keyframes, b.keyframes):
            np.testing.assert_array_equal(ka.image, kb.image)
            assert ka.kf_id == kb.kf_id and ka.timestamp == kb.timestamp
        if a.points_xyz is not None:
            np.testing.assert_array_equal(a.points_xyz, b.points_xyz)
    # the port's stream unpickles into the port's classes
    assert isinstance(streams["port"][0], protocol.MappingOperation)
    with open(tmp_path / "port.pkl", "rb") as f:
        assert type(pickle.load(f)).__module__ == protocol.__name__


YAML_TEXT = """%YAML:1.0
# a reference-style gaussian-mapper config
Model.feat_dim: 16
Model.n_offsets: 5
Model.voxel_size: 0.01   # trailing
Model.appearance_dim: 8
Optimization.max_num_iterations: 7000
Optimization.update_from: 700
Optimization.densify_grad_threshold: 0.0003
Mapper.use_frequency_regularization: 1
Mapper.min_num_initial_map_kfs: 5
Mapper.new_keyframe_times_of_use: 6
GausPyramid.do: 1
GausPyramid.num_sub_levels: 2
GausPyramid.sub_level_times_of_use: 3
Name.string: hello
"""


def test_load_mapper_yaml_matches_jax(tmp_path):
    p = tmp_path / "m.yaml"
    p.write_text(YAML_TEXT)
    assert config_yaml.parse_opencv_yaml(p) == jyaml.parse_opencv_yaml(p)
    ours = config_yaml.load_mapper_yaml(p, capacity=512)
    ref = jyaml.load_mapper_yaml(p, capacity=512)
    for a, b in zip(ours[:3], ref[:3]):
        assert type(a).__name__ == type(b).__name__
        assert dataclass_dict(a) == dataclass_dict(b)
    assert ours[3] == ref[3]
    assert ours[0].feat_dim == 16 and ours[3]["gaus_pyramid_do"]


def dataclass_dict(x) -> dict:
    import dataclasses

    return dataclasses.asdict(x)


@pytest.mark.skipif(not REF.exists(), reason="reference cfg not mounted")
def test_load_reference_replica_config():
    yaml = REF / "RGB-D/Replica/replica_rgbd.yaml"
    ours = config_yaml.load_mapper_yaml(yaml)
    ref = jyaml.load_mapper_yaml(yaml)
    for a, b in zip(ours[:3], ref[:3]):
        assert dataclass_dict(a) == dataclass_dict(b)
    assert ours[0].feat_dim == 32 and not ours[3]["gaus_pyramid_do"]


def test_parse_handles_comments_and_directives(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("""%YAML:1.0
# comment
Model.feat_dim: 16  # trailing
Model.voxel_size: 0.01
Name.string: hello
""")
    y = config_yaml.parse_opencv_yaml(p)
    assert y == {"Model.feat_dim": 16, "Model.voxel_size": 0.01,
                 "Name.string": "hello"}


def _args(mod, extra=None):
    p = argparse.ArgumentParser()
    mod.add_common_args(p)
    return p.parse_args(extra or [])


def _resolved(extra, iters, **kw):
    """resolve_configs of both packages on the same flags, as dicts."""
    out = []
    for mod in (common, jcommon):
        mc, oc, mpc, rc, tkw = mod.resolve_configs(_args(mod, extra), iters,
                                                   **kw)
        rcd = dataclass_dict(rc)
        rcd.pop("kanchor", None)
        rcd.pop("kgroup", None)
        out.append((dataclass_dict(mc), dataclass_dict(oc),
                    dataclass_dict(mpc), rcd, tkw))
    return out


def test_resolve_configs_matches_jax(tmp_path):
    """test_app_config.py's cases on the port, each against the JAX
    function: defaults, dual rate off, a YAML driving model/opt and the
    pyramid (the reference configs where mounted, else a reference-style
    file), mapper overrides, --opt-set / --model-set, packed_train."""
    yaml = tmp_path / "m.yaml"
    yaml.write_text(YAML_TEXT)
    cases = [([], 1234, {}), (["--ksmall", "0"], 100, {}),
             (["--mapper-yaml", str(yaml)], 0, {}),
             (["--mapper-yaml", str(yaml)], 100, {}),
             ([], 10, dict(mapper_overrides=dict(pose_refine_every=25))),
             (["--opt-set", "pose_prior=0.005", "--model-set",
               "appearance_dim=0", "--kmax", "40"], 10, {}),
             (["--packed-train", "off"], 10, {})]
    for name in ("RGB-D/Replica/replica_rgbd.yaml",
                 "Stereo/KITTI/kitti_stereo.yaml"):
        if (REF / name).exists():
            cases.append((["--mapper-yaml", str(REF / name)], 100, {}))
    for extra, iters, kw in cases:
        ours, ref = _resolved(extra, iters, **kw)
        assert ours == ref, extra
    mc, oc, mpc, rc, tkw = common.resolve_configs(_args(common), 1234)
    assert oc.iterations == 1234 and mc.capacity == 2**16 and tkw == {}
    assert rc.ksmall == 4 and rc.nlarge == 2**13 and rc.packed_train
    _, _, _, rc, _ = common.resolve_configs(_args(common, ["--ksmall", "0"]),
                                            100)
    assert rc.max_instances == rc.compact * rc.kmax
    _, oc, _, _, tkw = common.resolve_configs(
        _args(common, ["--mapper-yaml", str(yaml)]), 0)
    assert oc.iterations == 7000 and tkw["num_pyramid_sub_levels"] == 2
    assert tkw["pyramid_times_of_use"] == 3
    assert tkw["keyframe_times_of_use"] == 6
    args = _args(common)
    assert common.resolve_dist_coeffs(args, "tum") is not None
    assert common.resolve_dist_coeffs(args, "replica") is None
    assert common.resolve_dist_coeffs(
        _args(common, ["--undistort", "off"]), "tum") is None
    for extra in (["--viewer-port", "8080"], ["--kanchor", "4"],
                  ["--opt-set", "no_such_field=1"]):
        with pytest.raises(SystemExit):
            common.resolve_configs(_args(common, extra), 10)


def test_maker_arrays_match_jax():
    """render_frames' rgb and depth before encoding against the JAX maker's
    jitted rasterize on the same scene and poses (3 frames at 64x48)."""
    scene, poses = maker.scene_and_poses(3, 2000, seed=0, loop=False)
    cam = Camera(camera_id=0, width=SEQ_W, height=SEQ_H, fx=0.9 * SEQ_W,
                 fy=0.9 * SEQ_W, cx=SEQ_W / 2, cy=SEQ_H / 2)
    jcam = JCamera(camera_id=0, width=SEQ_W, height=SEQ_H, fx=0.9 * SEQ_W,
                   fy=0.9 * SEQ_W, cx=SEQ_W / 2, cy=SEQ_H / 2)
    cfg = JRasterConfig(tile=16, compact=2**14, kmax=16, chunk=128)
    arrs = [jnp.asarray(x) for x in scene]

    @jax.jit
    def _render(wvt, fpt):
        o = j_rasterize(*arrs, wvt, fpt, SEQ_W, SEQ_H, jcam.tan_fovx,
                        jcam.tan_fovy, jnp.zeros(3), config=cfg)
        return o["image"], o["depth_map"], o["final_T"]

    frames = list(maker.render_frames(scene, poses, cam, device="cpu"))
    assert len(frames) == 3
    for (i, kf, rgb, d), (q, t) in zip(frames, poses):
        jkf = JKeyframe(kf_id=i, camera=jcam, quat=q, trans=t)
        img, depth, final_t = _render(jnp.asarray(jkf.world_view_transform),
                                      jnp.asarray(jkf.full_proj_transform))
        ref_rgb = np.clip(np.asarray(img).transpose(1, 2, 0), 0, 1)
        alpha = 1.0 - np.asarray(final_t)
        ref_d = np.where(alpha > 0.5,
                         np.asarray(depth) / np.maximum(alpha, 1e-6), 0.0)
        assert rgb.max() > 0.05 and (d > 0).mean() > 0.5
        np.testing.assert_allclose(rgb, ref_rgb, atol=2e-4, rtol=0)
        np.testing.assert_allclose(d, ref_d, atol=2e-4, rtol=1e-4)
    with pytest.raises(SystemExit):
        maker.main(["--out", "unused", "--imu"])


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """An 8-frame 64x48 Replica-layout sequence written by the port's
    maker on the CPU."""
    out = tmp_path_factory.mktemp("seq")
    maker.main(["--out", str(out), "--frames", "8", "--width", str(SEQ_W),
                "--height", str(SEQ_H), "--gaussians", "2000", "--device",
                "cpu"])
    return out


def test_load_replica_matches_jax(sequence):
    ours, ref = datasets.load_replica(sequence), jdatasets.load_replica(
        sequence)
    assert len(ours) == len(ref) == 8
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.quat, b.quat)
        np.testing.assert_array_equal(a.trans, b.trans)
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.load_rgb(), b.load_rgb())
        np.testing.assert_array_equal(a.load_depth(6553.5),
                                      b.load_depth(6553.5))
    # the oracle's poses are the maker's trajectory
    poses = maker.scene_and_poses(8, 2000, seed=0, loop=False)[1]
    def rot(q):
        return se3.quat_to_rotmat(torch.as_tensor(np.asarray(q, np.float32)))

    for fr, (q, t) in zip(ours, poses):
        np.testing.assert_allclose(rot(fr.quat), rot(q), atol=1e-6)
        np.testing.assert_allclose(fr.trans, t, atol=1e-6)


def test_checkpoint_artifacts_match_jax(tmp_path):
    """save_mlp_checkpoints_txt and save_cameras_json write the JAX
    package's files for the same weights and keyframes; the train state
    round-trips through save/load_train_state."""
    jmc = JModelConfig(feat_dim=8, n_offsets=4, appearance_dim=8,
                       embedding_dim=4)
    jdec = init_decoders(jax.random.PRNGKey(3), jmc)
    jckpt.save_mlp_checkpoints_txt(tmp_path / "j", jdec)
    dec = decoders_from_jax(flatten_params(jax.tree.map(np.asarray, jdec)))
    checkpoint.save_mlp_checkpoints_txt(tmp_path / "t", dec)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert "mlp_color_l2_weight.txt" in names
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes(), n

    kfs = {}
    for name, cam_cls, kf_cls in (("j", JCamera, JKeyframe),
                                  ("t", Camera, Keyframe)):
        cam = cam_cls(camera_id=0, width=64, height=48, fx=50.0, fy=51.0,
                      cx=32.0, cy=24.0)
        kfs[name] = {i: kf_cls(kf_id=i, camera=cam,
                               quat=[0.98, 0.05 * i, -0.1, 0.02],
                               trans=[0.1 * i, -0.2, 0.3]) for i in (5, 0, 3)}
    jckpt.save_cameras_json(tmp_path / "j.json", kfs["j"])
    checkpoint.save_cameras_json(tmp_path / "t.json", kfs["t"])
    assert json.loads((tmp_path / "t.json").read_text()) == json.loads(
        (tmp_path / "j.json").read_text())
    jckpt.save_cfg_args(tmp_path / "j_cfg", jmc, False, "src")
    checkpoint.save_cfg_args(tmp_path / "t_cfg", jmc, False, "src")
    assert (tmp_path / "t_cfg").read_text() == (tmp_path / "j_cfg").read_text()

    from segs_slam_tpu_torch.models.anchors import empty_state
    from segs_slam_tpu_torch.models.config import ModelConfig
    from segs_slam_tpu_torch.train.step import init_train_state

    mc = ModelConfig(feat_dim=8, n_offsets=4, appearance_dim=8,
                     embedding_dim=4, capacity=32)
    ts = init_train_state(empty_state(mc, "cpu"), dec, mc, max_pose_kfs=3)
    ts.pose.normal_()
    checkpoint.save_train_state(tmp_path / "ts.pt", ts)
    back = checkpoint.load_train_state(tmp_path / "ts.pt")
    assert torch.equal(back.pose, ts.pose) and back.step == ts.step
    assert torch.equal(back.adam.mu["pose"], ts.adam.mu["pose"])


APP_ARGS = ["--dataset", "replica", "--tracker", "oracle", "--width",
            str(SEQ_W), "--height", str(SEQ_H), "--fx", "57.6", "--fy",
            "57.6", "--cx", "32", "--cy", "24", "--iters-budget", "10",
            "--min-init-kfs", "2", "--keyframe-every", "2", "--capacity",
            "512", "--compact", "2048", "--nlarge", "256", "--model-set",
            "feat_dim=8", "--model-set", "n_offsets=4", "--model-set",
            "appearance_dim=8", "--device", "cpu"]


def test_slam_rgbd_end_to_end(sequence, tmp_path):
    """slam_rgbd on the 8-frame sequence with the pose oracle, 10
    iterations, on the packed training binning: every output file, the
    all-frames evaluation, and the ATE against groundtruth.txt."""
    out = tmp_path / "run"
    before = dict(tblend.train_binnings)
    res = slam_rgbd.main(APP_ARGS + ["--path", str(sequence), "--out",
                                     str(out), "--all-frames-eval"])
    assert res["iterations"] == 10 and res["folded"] == 0
    assert tblend.train_binnings["packed"] >= before["packed"] + 10
    assert tblend.train_binnings["f32"] == before["f32"]
    for name in ("CameraTrajectory_TUM.txt", "groundtruth.txt", "psnr.txt",
                 "dssim.txt", "psnr_gaussian_splatting.txt",
                 "render_time.txt", "render_time_per_dispatch.txt",
                 "gaussians_num.txt", "keyframe_used_times.txt",
                 "TrackingTime.txt", "RunningTime.txt", "anchors.ply",
                 "cameras.json", "mlps/mlp_opacity_l1_weight.txt",
                 "rendered/000000.png", "ground_truth/000006.png",
                 "10_images/psnr.txt", "10_images/AllCameraTrajectory_TUM.txt"):
        assert (out / name).is_file(), name
    assert len(json.loads((out / "cameras.json").read_text())) == 4
    assert len((out / "10_images/psnr.txt").read_text().splitlines()) == 8
    run = harness.evaluate_run(out)
    assert run["ate_rmse"] < 1e-5
    assert np.isfinite(run["psnr"]) and np.isfinite(run["render_fps"])
    assert res["trainer"].device.type == "cpu"


def test_slam_rgbd_refuses_unported(sequence, tmp_path):
    """--tracker native and --viewer-port raise; nothing falls back."""
    base = APP_ARGS + ["--path", str(sequence), "--out", str(tmp_path)]
    for extra in (["--tracker", "native"], ["--viewer-port", "8000"]):
        with pytest.raises(SystemExit):
            slam_rgbd.main(base + extra)
