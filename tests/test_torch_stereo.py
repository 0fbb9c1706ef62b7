"""The port's stereo path on the CPU: the analogues of tests/test_stereo.py
(rectification, its pose round trip, the stereo densifier, the oracle
producer), the synthetic stereo maker against the JAX maker (the CSVs and
calib.json equal, the ground-truth body quaternions within 1e-6, every PNG
within one 8-bit level), slam_stereo's producer with each tracker against
JAX's (equal streams, as tests/test_torch_producers.py holds the others),
and slam_stereo end to end with the pose oracle.
"""

import json
import threading

import numpy as np
import pytest
import torch

from segs_slam_tpu.native import native_available as jax_native_available
from segs_slam_tpu.utils import make_stereo_dataset as jmaker
from segs_slam_tpu_torch.apps import slam_stereo
from segs_slam_tpu_torch.core import se3
from segs_slam_tpu_torch.core.camera import Camera
from segs_slam_tpu_torch.core.undistort import StereoRectifyMap
from segs_slam_tpu_torch.eval import metrics as M
from segs_slam_tpu_torch.io import datasets
from segs_slam_tpu_torch.io.datasets import Frame
from segs_slam_tpu_torch.ops.rasterizer import blend as tblend
from segs_slam_tpu_torch.slam import frontends
from segs_slam_tpu_torch.slam.protocol import MappingQueue
from segs_slam_tpu_torch.utils import make_stereo_dataset as maker
from test_stereo import _smooth_noise
from test_torch_producers import (
    STEREO_FRAMES,
    STEREO_H,
    STEREO_W,
    _run_both,
    assert_streams_equal,
)
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

SEQ_W, SEQ_H = 96, 72


def _euroc_cams():
    e0, e1 = slam_stereo.EUROC_CAM0, slam_stereo.EUROC_CAM1
    camL = Camera(camera_id=0, width=e0["w"], height=e0["h"], fx=e0["fx"],
                  fy=e0["fy"], cx=e0["cx"], cy=e0["cy"],
                  dist_coeffs=e0["dist"])
    camR = Camera(camera_id=1, width=e1["w"], height=e1["h"], fx=e1["fx"],
                  fy=e1["fy"], cx=e1["cx"], cy=e1["cy"],
                  dist_coeffs=e1["dist"])
    T_10 = np.linalg.inv(slam_stereo.EUROC_T_BS1) @ slam_stereo.EUROC_T_BS0
    return camL, camR, T_10[:3, :3], T_10[:3, 3]


def test_stereo_rectify_epipolar_alignment():
    camL, camR, R, t = _euroc_cams()
    sr = StereoRectifyMap(camL, camR, R, t)
    assert abs(sr.baseline - 0.1101) < 5e-4  # EuRoC stereo baseline
    rng = np.random.default_rng(0)
    P0 = np.stack([rng.uniform(-1, 1, 50), rng.uniform(-0.6, 0.6, 50),
                   rng.uniform(2, 8, 50)], 1)
    Pr1 = P0 @ sr.R1.T
    Pr2 = (P0 @ R.T + t) @ sr.R2.T
    K = sr.camera
    v1 = K.fy * Pr1[:, 1] / Pr1[:, 2] + K.cy
    v2 = K.fy * Pr2[:, 1] / Pr2[:, 2] + K.cy
    u1 = K.fx * Pr1[:, 0] / Pr1[:, 2] + K.cx
    u2 = K.fx * Pr2[:, 0] / Pr2[:, 2] + K.cx
    # rectified: rows align, disparity = fx * b / z
    np.testing.assert_allclose(v1, v2, atol=1e-8)
    np.testing.assert_allclose(u1 - u2, K.fx * sr.baseline / Pr1[:, 2],
                               atol=1e-8)
    np.testing.assert_allclose(sr.R1 @ sr.R1.T, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(sr.R2 @ sr.R2.T, np.eye(3), atol=1e-12)
    # the app's rectifier is this one
    app = slam_stereo.build_rectifier(1)
    np.testing.assert_array_equal(app.R1, sr.R1)
    assert app.baseline == sr.baseline


def test_stereo_rectify_pose_roundtrip():
    camL, camR, R, t = _euroc_cams()
    sr = StereoRectifyMap(camL, camR, R, t, scale=2)
    assert sr.camera.width == 376 and sr.camera.height == 240
    q = np.array([0.9238795, 0.0, 0.3826834, 0.0], np.float32)  # 45 deg y
    tr = np.array([0.3, -0.2, 1.0], np.float32)
    q2, t2 = sr.rectify_pose(q, tr)
    # the rectified pose keeps the camera centre fixed in world space
    R0 = se3.quat_to_rotmat(torch.as_tensor(q)).numpy()
    R2_ = se3.quat_to_rotmat(torch.as_tensor(np.asarray(q2))).numpy()
    np.testing.assert_allclose(-R0.T @ tr, -R2_.T @ t2, atol=1e-5)


def test_stereo_densify_recovers_plane_depth():
    # distortion-free, pre-rectified pair: right = left shifted by d pixels
    h, w, d = 64, 288, 16.0
    cam = Camera(camera_id=0, width=w, height=h, fx=200.0, fy=200.0,
                 cx=(w - 1) / 2, cy=(h - 1) / 2)
    baseline = 0.11
    z_true = cam.fx * baseline / d
    left = _smooth_noise(np.random.default_rng(1), h, w)
    right = np.roll(left, -int(d), axis=1)
    pts = frontends.stereo_densify(left, right, cam, baseline,
                                   np.array([1.0, 0, 0, 0]), np.zeros(3),
                                   max_depth=10.0)
    assert len(pts) > 50
    # identity pose: world z == camera depth
    assert abs(np.median(pts[:, 2]) - z_true) / z_true < 0.08
    # the app's pseudo-depth of the same pair sees the same plane
    depth = slam_stereo._depth_from_disparity(left, right, cam, baseline)
    assert depth.shape == left.shape
    assert abs(np.median(depth[depth > 0]) - z_true) / z_true < 0.08


def test_stereo_producer_smoke(tmp_path):
    from PIL import Image

    h, w, d = 64, 288, 16.0
    cam = Camera(camera_id=0, width=w, height=h, fx=200.0, fy=200.0,
                 cx=(w - 1) / 2, cy=(h - 1) / 2)
    rng = np.random.default_rng(2)
    pairs = []
    for i in range(3):
        left = _smooth_noise(rng, h, w)
        right = np.roll(left, -int(d), axis=1)
        lp, rp = tmp_path / f"l{i}.png", tmp_path / f"r{i}.png"
        Image.fromarray((left * 255).astype(np.uint8)).save(lp)
        Image.fromarray((right * 255).astype(np.uint8)).save(rp)
        pairs.append((Frame(timestamp=float(i), quat=np.array([1.0, 0, 0, 0]),
                            trans=np.array([0.0, 0, float(i) * 0.01]),
                            rgb_path=str(lp)), str(rp)))
    queue = MappingQueue()
    rows = slam_stereo.run_stereo_producer(
        pairs, slam_stereo.PreRectified(cam, 0.11), queue, "oracle",
        keyframe_every=1, points_per_kf=200, tracking_times=[],
        stop_event=threading.Event())
    assert len(rows) == 3
    ops = []
    while (op := queue.pop(timeout=0.01)) is not None:
        ops.append(op)
    assert len(ops) == 3
    z_true = cam.fx * 0.11 / d
    for op in ops:
        assert op.keyframes[0].image.shape == (h, w, 3)
        assert op.points_xyz is not None and len(op.points_xyz) > 50
        assert abs(np.median(op.points_xyz[:, 2]) - z_true) / z_true < 0.15


@pytest.fixture(scope="module")
def stereo_seqs(tmp_path_factory):
    """The same 8-pair 96x72 sequence written by both packages' makers."""
    root = tmp_path_factory.mktemp("stereo")
    args = ["--frames", "8", "--width", str(SEQ_W), "--height", str(SEQ_H),
            "--gaussians", "2000"]
    jmaker.main(["--out", str(root / "jax")] + args)
    maker.main(["--out", str(root / "port"), "--device", "cpu"] + args)
    return root / "jax", root / "port"


def test_stereo_maker_matches_jax(stereo_seqs):
    from PIL import Image

    ref, ours = stereo_seqs
    for rel in ("mav0/cam0/data.csv", "mav0/cam1/data.csv"):
        assert (ours / rel).read_text() == (ref / rel).read_text(), rel
    assert json.loads((ours / "calib.json").read_text()) == json.loads(
        (ref / "calib.json").read_text())
    gt = "mav0/state_groundtruth_estimate0/data.csv"
    rows = [ln.split(",") for ln in (ours / gt).read_text().splitlines()]
    ref_rows = [ln.split(",") for ln in (ref / gt).read_text().splitlines()]
    assert rows[0] == ref_rows[0] and len(rows) == len(ref_rows) == 9
    for a, b in zip(rows[1:], ref_rows[1:]):
        assert a[:4] == b[:4]  # timestamp and body position
        np.testing.assert_allclose(np.float64(a[4:]), np.float64(b[4:]),
                                   atol=1e-6, rtol=0)
    for cam in ("cam0", "cam1"):
        names = sorted(p.name for p in (ref / "mav0" / cam / "data").iterdir())
        assert names == sorted(
            p.name for p in (ours / "mav0" / cam / "data").iterdir())
        for n in names:
            a = np.asarray(Image.open(ours / "mav0" / cam / "data" / n),
                           np.int16)
            b = np.asarray(Image.open(ref / "mav0" / cam / "data" / n),
                           np.int16)
            assert a.shape == (SEQ_H, SEQ_W) and a.max() > 10
            assert np.abs(a - b).max() <= 1, (cam, n)
    # the diagnostic depth: equal within the blend tolerance where both
    # renders hold a surface; the alpha > 0.5 test may flip on a pixel
    # whose alpha lies within the tolerance of 0.5
    flips = 0
    for n in sorted(p.name for p in (ref / "mav0/depth0").iterdir()):
        a, b = np.load(ours / "mav0/depth0" / n), np.load(
            ref / "mav0/depth0" / n)
        both = (a > 0) & (b > 0)
        assert both.mean() > 0.5
        flips += int(((a > 0) != (b > 0)).sum())
        np.testing.assert_allclose(a[both], b[both], atol=2e-4, rtol=1e-4)
    assert flips <= 2
    # the loader recovers the maker's trajectory
    from segs_slam_tpu_torch.utils.synthetic import make_trajectory

    pairs = datasets.load_euroc_stereo(ours)
    for (fr, right), (q, t) in zip(pairs, make_trajectory(8)):
        assert right is not None
        R = se3.quat_to_rotmat(torch.as_tensor(np.asarray(q, np.float32)))
        Rf = se3.quat_to_rotmat(torch.as_tensor(np.asarray(fr.quat,
                                                           np.float32)))
        np.testing.assert_allclose(Rf.numpy(), R.numpy(), atol=2e-6)
        np.testing.assert_allclose(fr.trans, t, atol=2e-6)


def test_slam_stereo_end_to_end(stereo_seqs, tmp_path):
    """slam_stereo --pre-rectified --tracker oracle on the port's sequence,
    10 iterations on the CPU at the app's kmax 16 (packed binning): it writes
    the JAX app's files, and the estimated trajectory is the ground truth."""
    _, ours = stereo_seqs
    out = tmp_path / "run"
    before = dict(tblend.train_binnings)
    res = slam_stereo.main([
        "--path", str(ours), "--out", str(out), "--pre-rectified",
        "--tracker", "oracle", "--iters-budget", "10", "--min-init-kfs", "2",
        "--keyframe-every", "2", "--capacity", "512", "--compact", "2048",
        "--nlarge", "256", "--model-set", "feat_dim=8", "--model-set",
        "n_offsets=4", "--model-set", "appearance_dim=8", "--device", "cpu"])
    assert res["iterations"] == 10
    assert tblend.train_binnings["packed"] >= before["packed"] + 10
    assert res["trainer"].raster_config.kmax == 16
    for name in ("CameraTrajectory_TUM.txt", "psnr.txt", "anchors.ply",
                 "rendered/000000.png"):
        assert (out / name).is_file(), name
    assert np.isfinite(res["psnr"])
    _, est, _ = M.load_tum_trajectory(out / "CameraTrajectory_TUM.txt")
    pairs = datasets.load_euroc_stereo(ours)
    gt = np.stack([
        -se3.quat_to_rotmat(torch.as_tensor(np.asarray(
            fr.quat, np.float32))).numpy().T @ np.asarray(fr.trans,
                                                          np.float32)
        for fr, _ in pairs])
    assert est.shape == gt.shape
    assert M.ate_rmse(est, gt)["ate_rmse"] < 1e-5


@pytest.fixture(scope="module")
def stereo_seq(tmp_path_factory):
    assert jax_native_available()
    out = tmp_path_factory.mktemp("stereo")
    maker.main([
        "--out", str(out), "--frames", str(STEREO_FRAMES), "--width",
        str(STEREO_W), "--height", str(STEREO_H), "--device", "cpu"])
    return out


@pytest.mark.parametrize("tracker", ["oracle", "native"])
def test_stereo_producer_matches_jax(stereo_seq, tmp_path, tracker):
    """slam_stereo's producer with each tracker on a pre-rectified pair
    stream: keyframes, their stereo-densified points; equal to JAX's."""
    ref, ours = _run_both(f"stereo-{tracker}", stereo_seq, tmp_path)
    assert_streams_equal(ours, ref)
    ops, rows = ours
    assert len(rows) == STEREO_FRAMES
    assert len(ops) >= 3 and all(o.points_xyz is not None for o in ops)
