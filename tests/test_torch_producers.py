"""The tracking producers of the port's SLAM apps against the JAX apps' on
the same sequences: slam_rgbd's native producer (native loader, tracker,
IMU feed, loop closure, final-trajectory rewrite); tests/test_torch_mono.py
and tests/test_torch_stereo.py hold slam_mono's (mono-inertial) and
slam_stereo's with each tracker the same way. Each side runs in a subprocess of its own (both at
once, OpenCV's parallel_for serial in both: see tests/test_torch_native.py),
records its whole MappingOperation stream, and the streams must be equal:
kinds, keyframe ids, poses, images, depths, keypoints, points, point ids,
pose updates, scales and the returned trajectory rows. Equal means
bit-equal: both packages compile the same tracker sources with the same
flags, and every host computation around them is the same numpy.

Then slam_rgbd at its default --tracker native end to end on the CPU, on
the same sequence.
"""

import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from segs_slam_tpu.native import native_available as jax_native_available
from segs_slam_tpu_torch.apps import slam_rgbd
from segs_slam_tpu_torch.eval import harness
from segs_slam_tpu_torch.eval import metrics as M
from segs_slam_tpu_torch.slam import protocol
from segs_slam_tpu_torch.slam.protocol import OperationKind
from segs_slam_tpu_torch.utils import make_rgbd_dataset
from test_torch_native import serial_opencv  # noqa: F401 (fixture)
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
# a closed orbit at 320x240: the tracker keeps about 40 keyframes and closes
# the loop at the revisit (140 frames; at 160 it does not)
LOOP_W, LOOP_H, LOOP_FRAMES = 320, 240, 140
# the mono maker's sequence at its default 320x320, cut to 60 frames
MONO_SIZE, MONO_FRAMES = 320, 60
STEREO_W, STEREO_H, STEREO_FRAMES = 320, 240, 24


def _child(pkg: str, kind: str, seq: str, out: str) -> None:
    """Run one package's producer on `seq` and pickle (ops, rows) to
    `out`; called in a subprocess by _run_both."""
    import importlib
    import threading

    base = "segs_slam_tpu" if pkg == "jax" else "segs_slam_tpu_torch"
    if pkg == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
    datasets = importlib.import_module(f"{base}.io.datasets")
    camera = importlib.import_module(f"{base}.core.camera")
    proto = importlib.import_module(f"{base}.slam.protocol")
    make_imu = importlib.import_module(f"{base}.utils.make_imu")
    queue = proto.MappingQueue()
    stop = threading.Event()
    if kind in ("rgbd", "mono"):
        frames = datasets.load_replica(seq)
        w, h = (LOOP_W, LOOP_H) if kind == "rgbd" else (MONO_SIZE,) * 2
        cam = camera.Camera(camera_id=0, width=w, height=h, fx=0.9 * w,
                            fy=0.9 * w, cx=w / 2, cy=h / 2)
        ts, gy, ac = make_imu.load_imu_txt(Path(seq) / "imu.txt")
        imu = (ts, gy, ac, [0])
        if kind == "rgbd":
            app = importlib.import_module(f"{base}.apps.slam_rgbd")
            rows = app.run_producer(frames, cam, queue, "native", 6553.5, 10,
                                    300, [], stop, imu=imu)
        else:
            app = importlib.import_module(f"{base}.apps.slam_mono")
            rows = app.run_mono_producer(frames, cam, queue, [], stop,
                                         imu=imu)
    else:
        import json

        app = importlib.import_module(f"{base}.apps.slam_stereo")
        calib = json.loads((Path(seq) / "calib.json").read_text())
        cam = camera.Camera(camera_id=0, width=calib["width"],
                            height=calib["height"], fx=calib["fx"],
                            fy=calib["fy"], cx=calib["cx"], cy=calib["cy"])
        rows = app.run_stereo_producer(
            datasets.load_euroc_stereo(seq),
            app.PreRectified(cam, calib["baseline"]), queue,
            kind.split("-")[1], 4, 400, [], stop)
    ops = []
    while (op := queue.pop(timeout=0.01)) is not None:
        ops.append(op)
    with open(out, "wb") as f:
        pickle.dump((ops, rows), f)


def _run_both(kind: str, seq: Path, tmp: Path):
    """(JAX's, the port's) (ops, rows), each from its own subprocess."""
    def run(pkg):
        out = tmp / f"{kind}-{pkg}.pkl"
        code = ("import sys; sys.path.insert(0, %r); import "
                "test_torch_producers as t; t._child(%r, %r, %r, %r)"
                % (str(ROOT / "tests"), pkg, kind, str(seq), str(out)))
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=600,
                             env=dict(os.environ, JAX_PLATFORMS="cpu",
                                      OPENCV_FOR_THREADS_NUM="1"))
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        with open(out, "rb") as f:
            return pickle.load(f)

    with ThreadPoolExecutor(2) as pool:
        return tuple(pool.map(run, ("jax", "port")))


def _equal(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)


def assert_streams_equal(ours, ref) -> None:
    """Two (ops, rows) results are the same stream."""
    (ops, rows), (rops, rrows) = ours, ref
    assert [int(o.kind) for o in ops] == [int(o.kind) for o in rops]
    for n, (a, b) in enumerate(zip(ops, rops)):
        assert isinstance(a, protocol.MappingOperation)
        assert [k.kf_id for k in a.keyframes] == \
            [k.kf_id for k in b.keyframes], n
        for ka, kb in zip(a.keyframes, b.keyframes):
            for field in ("quat", "trans", "image", "depth",
                          "keypoint_pixels", "keypoint_points"):
                _equal(getattr(ka, field), getattr(kb, field),
                       f"op {n} kf {ka.kf_id} {field}")
            assert (ka.timestamp, ka.camera_id) == (kb.timestamp,
                                                     kb.camera_id)
        for field in ("points_xyz", "point_ids", "transform"):
            _equal(getattr(a, field), getattr(b, field), f"op {n} {field}")
        assert a.scale == b.scale, n
        assert a.pose_updates.keys() == b.pose_updates.keys(), n
        for k, (q, t) in a.pose_updates.items():
            _equal(q, b.pose_updates[k][0], f"op {n} update {k}")
            _equal(t, b.pose_updates[k][1], f"op {n} update {k}")
    assert len(rows) == len(rrows)
    for (ts, q, t), (rts, rq, rt) in zip(rows, rrows):
        assert ts == rts
        _equal(q, rq, f"row {ts}")
        _equal(t, rt, f"row {ts}")


@pytest.fixture(scope="module")
def loop_seq(tmp_path_factory):
    """The port's make_rgbd_dataset --loop --imu at 320x240, and the JAX
    library built before both sides start."""
    assert jax_native_available()
    out = tmp_path_factory.mktemp("loop")
    make_rgbd_dataset.main([
        "--out", str(out), "--frames", str(LOOP_FRAMES), "--width",
        str(LOOP_W), "--height", str(LOOP_H), "--loop", "--imu",
        "--device", "cpu"])
    return out


def test_rgbd_native_producer_matches_jax(loop_seq, tmp_path):
    """slam_rgbd's native producer on a closed orbit with its IMU stream:
    keyframes with keypoints and window-pose updates, a LOOP_CLOSING_BA op
    with the corrected trajectory, the shutdown rewrite; equal to JAX's."""
    ref, ours = _run_both("rgbd", loop_seq, tmp_path)
    assert_streams_equal(ours, ref)
    ops, rows = ours
    kinds = [o.kind for o in ops]
    assert kinds.count(OperationKind.LOOP_CLOSING_BA) >= 1
    assert kinds[-1] == OperationKind.LOCAL_MAPPING_BA
    assert not ops[-1].keyframes and len(ops[-1].pose_updates) >= 20
    kf_ops = [o for o in ops if o.keyframes]
    assert len(kf_ops) >= 25
    assert all(o.keyframes[0].keypoint_pixels is not None and o.pose_updates
               and o.points_xyz is not None for o in kf_ops)
    assert len(rows) == LOOP_FRAMES


# the apps' flags for a small map on the CPU
SMALL_MAP = ["--iters-budget", "10", "--capacity", "1024", "--compact",
             "4096", "--nlarge", "512", "--model-set", "feat_dim=8",
             "--model-set", "n_offsets=4", "--model-set", "appearance_dim=8",
             "--device", "cpu"]


def test_slam_rgbd_native_tracker(loop_seq, tmp_path,
                                  serial_opencv):  # noqa: F811
    """slam_rgbd at its default --tracker native on the first 24 frames of
    the orbit with its imu.txt, 10 iterations on the CPU: the native loader
    and tracker push keyframes with keypoints, the mapper trains on them,
    every output file is written, and the trajectory holds one row a frame,
    close to the ground truth (the oracle's ATE is 0)."""
    out = tmp_path / "run"
    res = slam_rgbd.main([
        "--dataset", "replica", "--path", str(loop_seq), "--out", str(out),
        "--max-frames", "24", "--width", "320", "--height", "240", "--fx",
        "288", "--fy", "288", "--cx", "160", "--cy", "120",
        "--min-init-kfs", "2"] + SMALL_MAP)
    assert res["iterations"] == 10
    assert len(res["trainer"].scene.keyframes) >= 5
    for name in ("CameraTrajectory_TUM.txt", "groundtruth.txt", "psnr.txt",
                 "TrackingTime.txt", "anchors.ply", "cameras.json"):
        assert (out / name).is_file(), name
    times, est, _ = M.load_tum_trajectory(out / "CameraTrajectory_TUM.txt")
    assert len(times) == 24 and np.isfinite(est).all()
    run = harness.evaluate_run(out)
    assert run["ate_rmse"] < 0.1
    assert np.isfinite(run["psnr"])
