"""The port's native runtime (native/bindings.py) on the CPU.

The library is built from the port's own copies of the JAX package's
tracker and loader sources into build/, never into segs_slam_tpu/native/.
The analogues of tests/test_native.py, of
tests/test_imu.py::test_native_preintegration_matches_numpy and of
tests/test_atlas.py run those tests' own bodies with the port's
NativeTracker / NativeLoader in place of the JAX package's (the inertial
estimators' two long analogues are in test_torch_native_inertial.py and
test_torch_native_mono.py). Then both packages' trackers track the same
frames of the port's RGB-D maker and must agree exactly.

OpenCV's parallel_for runs serially in these tests (`serial_opencv`): the
tracker's results do not depend on its thread count (checked bit for bit
on the 140-frame orbit of tests/test_torch_producers.py, loop closure
included), and under a parallel test run its many small parallel regions
wait on descheduled threads for most of their time.
"""

import ctypes
from pathlib import Path

import numpy as np
import pytest

import test_atlas
import test_imu
import test_native
from segs_slam_tpu import native as jnative
from segs_slam_tpu_torch import native
from segs_slam_tpu_torch.core.camera import Camera
from segs_slam_tpu_torch.native import bindings
from segs_slam_tpu_torch.utils import make_rgbd_dataset
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def serial_opencv():
    """cv::setNumThreads(1) for the test, restored after: the OpenCV that
    the tracker links (found among the process's mappings once the port's
    library is loaded), through its C++ entry points."""
    native.library_path()
    with open("/proc/self/maps") as f:
        path = next(line.split()[-1] for line in f
                    if "libopencv_core" in line)
    core = ctypes.CDLL(path)
    before = core._ZN2cv13getNumThreadsEv()
    core._ZN2cv13setNumThreadsEi(1)
    yield
    core._ZN2cv13setNumThreadsEi(before)


pytestmark = pytest.mark.usefixtures("serial_opencv")


made = {"tracker": 0, "loader": 0}


class PortTracker(native.NativeTracker):
    """The port's tracker, counting its instances (so that a delegated test
    shows that it ran on the port's library)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        made["tracker"] += 1


class PortLoader(native.NativeLoader):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        made["loader"] += 1


@pytest.fixture
def port_tracker(monkeypatch):
    """The JAX tests' modules see the port's NativeTracker / NativeLoader."""
    made.update(tracker=0, loader=0)
    for mod in (test_native, test_atlas, jnative):
        monkeypatch.setattr(mod, "NativeTracker", PortTracker)
    monkeypatch.setattr(test_native, "NativeLoader", PortLoader)
    yield
    assert made["tracker"] + made["loader"] >= 1


def test_sources_are_the_jax_packages():
    """The port compiles byte-equal copies of the frozen JAX sources."""
    for name in bindings.SOURCES:
        ours = ROOT / "segs_slam_tpu_torch" / "native" / name
        ref = ROOT / "segs_slam_tpu" / "native" / name
        assert ours.read_bytes() == ref.read_bytes(), name


def test_library_is_built_under_build():
    lib = native.library_path().resolve()
    assert native.native_available()
    assert lib.parent == (ROOT / "build" / "segs_slam_tpu_torch").resolve()
    assert lib.name.startswith("libsegs_native-") and lib.suffix == ".so"
    assert (ROOT / "segs_slam_tpu" / "native") not in lib.parents
    assert lib.with_suffix(".log").read_text().startswith(
        " ".join(("g++", *bindings.CXX_FLAGS))[:20])
    # the build is keyed by the sources: built once, then found again
    assert bindings.build_native() == native.library_path()


@pytest.mark.parametrize("name", [
    "test_native_loader_roundtrip",
    "test_native_tracker_recovers_translation",
    "test_tracker_pose_export_apis",
    "test_pr_index_and_imu_init_apis"])
def test_native_analogue(name, port_tracker, tmp_path):
    """tests/test_native.py's test `name` on the port's library."""
    fn = getattr(test_native, name)
    fn(tmp_path) if name == "test_native_loader_roundtrip" else fn()


def test_native_preintegration_matches_numpy(port_tracker):
    test_imu.test_native_preintegration_matches_numpy()


def test_atlas_spawn_and_merge(port_tracker):
    test_atlas.test_atlas_spawn_and_merge()


def test_trackers_match_jax():
    """Both packages' trackers, in one process, on the first 20 frames of
    the port's make_rgbd_dataset --loop orbit at 320x240 (140 frames, 3
    degrees of orbit a frame, which the tracker follows; the size of the
    JAX native tests' scenes), rendered and fed without encoding: every
    status, pose and inlier count, every keyframe's points and window poses,
    and the final trajectory equal. Bit-equal, no tolerance: the sources and
    flags are the same, and the two libraries' shared OpenCV state did not
    make them differ."""
    assert jnative.native_available()
    w, h = 320, 240
    cam = Camera(camera_id=0, width=w, height=h, fx=0.9 * w, fy=0.9 * w,
                 cx=w / 2, cy=h / 2)
    scene, poses = make_rgbd_dataset.scene_and_poses(140, 8000, 0, loop=True)
    args = (cam.fx, cam.fy, cam.cx, cam.cy)
    ours, ref = native.NativeTracker(*args), jnative.NativeTracker(*args)
    n_kf = tracked = 0
    for _, _, rgb, depth in make_rgbd_dataset.render_frames(
            scene, poses[:20], cam, device="cpu"):
        gray = (rgb.mean(axis=2) * 255).astype(np.uint8)
        depth = depth.astype(np.float32)
        a, b = ours.track(gray, depth), ref.track(gray, depth)
        assert a[0] == b[0] and a[2] == b[2]
        np.testing.assert_array_equal(a[1], b[1])
        tracked += a[0] >= 0
        if a[0] == 1:
            n_kf += 1
            np.testing.assert_array_equal(ours.keyframe_points(),
                                          ref.keyframe_points())
            for x, y in zip(ours.window_poses(), ref.window_poses()):
                np.testing.assert_array_equal(x, y)
            assert ours.poll_loop() == ref.poll_loop()
    assert tracked == 20 and n_kf >= 5
    for x, y in zip(ours.trajectory(), ref.trajectory()):
        np.testing.assert_array_equal(x, y)
    assert len(ours.trajectory()[0]) == n_kf
    assert ours.map_info() == ref.map_info() == (0, 1, -1)
