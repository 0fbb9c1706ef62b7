"""slam_mono on the CPU: its producer (mono-inertial) against the JAX
app's, each in a subprocess of its own with equal op streams as
tests/test_torch_producers.py holds them, then the app end to end, on the
mono maker's sequence (make_dataset) with an IMU stream derived from its
trajectory as make_rgbd_dataset --imu derives it.
"""

import numpy as np
import pytest

from segs_slam_tpu.native import native_available as jax_native_available
from segs_slam_tpu_torch.apps import slam_mono
from segs_slam_tpu_torch.eval import harness
from segs_slam_tpu_torch.ops.rasterizer import blend as tblend
from segs_slam_tpu_torch.slam.protocol import OperationKind
from segs_slam_tpu_torch.utils import make_dataset
from segs_slam_tpu_torch.utils.make_imu import derive_imu, write_imu_txt
from segs_slam_tpu_torch.utils.synthetic import make_trajectory
from test_torch_native import serial_opencv  # noqa: F401 (fixture)
from test_torch_producers import (
    MONO_FRAMES,
    MONO_SIZE,
    SMALL_MAP,
    _run_both,
    assert_streams_equal,
)
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def mono_seq(tmp_path_factory):
    """The port's make_dataset with its imu.txt."""
    assert jax_native_available()
    out = tmp_path_factory.mktemp("mono")
    make_dataset.main(["--out", str(out), "--frames", str(MONO_FRAMES),
                       "--size", str(MONO_SIZE), "--device", "cpu"])
    times, gyro, accel = derive_imu(make_trajectory(MONO_FRAMES),
                                    gyro_noise=2e-4, accel_noise=2e-3)
    write_imu_txt(out / "imu.txt", times, gyro, accel)
    return out


def test_mono_producer_matches_jax(mono_seq, tmp_path):
    """slam_mono's producer, mono-inertial: the bootstrap, keyframes with
    keypoint payloads, the pose updates and the scale refinements; equal to
    JAX's."""
    ref, ours = _run_both("mono", mono_seq, tmp_path)
    assert_streams_equal(ours, ref)
    ops, rows = ours
    kf_ops = [o for o in ops if o.keyframes]
    assert len(kf_ops) >= 10
    assert all(o.keyframes[0].keypoint_points is not None for o in kf_ops)
    assert any(o.kind == OperationKind.SCALE_REFINEMENT for o in ops)
    assert len(rows) == MONO_FRAMES


def test_slam_mono_end_to_end(mono_seq, tmp_path,
                              serial_opencv):  # noqa: F811
    """slam_mono on the first 30 frames of the mono sequence with its
    imu.txt, 10 iterations on the CPU: the tracker bootstraps and pushes at
    least --min-init-kfs keyframes, every step takes the packed binning,
    and the JAX app's files are written with a finite similarity-aligned
    ATE."""
    out = tmp_path / "run"
    before = dict(tblend.train_binnings)
    res = slam_mono.main([
        "--dataset", "replica", "--path", str(mono_seq), "--out", str(out),
        "--max-frames", "30", "--width", "320", "--height", "320", "--fx",
        "288", "--fy", "288", "--cx", "160", "--cy", "160"] + SMALL_MAP)
    assert res["iterations"] == 10
    t = res["trainer"]
    assert len(t.scene.keyframes) >= 5
    assert tblend.train_binnings["packed"] >= before["packed"] + 10
    for name in ("CameraTrajectory_TUM.txt", "groundtruth.txt", "psnr.txt",
                 "anchors.ply", "cameras.json",
                 "mlps/mlp_opacity_l1_weight.txt"):
        assert (out / name).exists(), name
    assert len(list((out / "rendered").glob("*.png"))) == len(
        t.scene.keyframes)
    assert np.isfinite(res["ate_rmse_scaled"]) and res["ate_scale"] > 0
    assert np.isfinite(harness.evaluate_run(out)["psnr"])
