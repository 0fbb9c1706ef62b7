"""ctypes bindings for the native runtime (dataloader + tracker).

Port of segs_slam_tpu/native/bindings.py. The library is compiled from this
package's own copies of `dataloader.cpp` and `tracker.cpp` (host C++ on
OpenCV 4) with the JAX package's build flags (its build.sh), on first use,
into `build/segs_slam_tpu_torch/libsegs_native-<hash>.so` at the root of the
checkout, named by a hash of the sources and the command line so that a
stale build is never loaded, as `ops/cuda_lib.py` builds the kernels. The
compiler's output is kept beside it as `<lib>.log`. A failed build raises
with that output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from segs_slam_tpu_torch.ops.cuda_lib import BUILD_DIR

_DIR = Path(__file__).resolve().parent
SOURCES = ("dataloader.cpp", "tracker.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-I/usr/include/opencv4")
LIBS = ("-lopencv_core", "-lopencv_imgcodecs", "-lopencv_imgproc",
        "-lopencv_calib3d", "-lopencv_features2d", "-lpthread")


def build_native() -> Path:
    """Compile the native library (if not already built) and return the .so
    path."""
    cxx = os.environ.get("CXX", "g++")
    srcs = [_DIR / s for s in SOURCES]
    digest = hashlib.sha256(
        b"".join(s.read_bytes() for s in srcs)
        + " ".join((cxx, *CXX_FLAGS, *LIBS)).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libsegs_native-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, *map(str, srcs), "-o", str(tmp), *LIBS]
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = " ".join(cmd) + "\n" + res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native library failed:\n{log}")
    tmp_log = tmp.with_suffix(".log")
    tmp_log.write_text(log)
    os.replace(tmp_log, lib.with_suffix(".log"))
    os.replace(tmp, lib)
    return lib


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native()))
    lib.sg_loader_create.restype = ctypes.c_void_p
    lib.sg_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ]
    lib.sg_loader_set_undistort.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.POINTER(ctypes.c_double),
    ]
    lib.sg_loader_dims.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.sg_loader_next.restype = ctypes.c_int
    lib.sg_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
    ]
    lib.sg_loader_destroy.argtypes = [ctypes.c_void_p]

    lib.sg_tracker_create.restype = ctypes.c_void_p
    lib.sg_tracker_create.argtypes = [
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int,
    ]
    lib.sg_tracker_track.restype = ctypes.c_int
    lib.sg_tracker_track.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
    ]
    lib.sg_tracker_track_stereo.restype = ctypes.c_int
    lib.sg_tracker_track_stereo.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte),
        ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.sg_tracker_track_mono.restype = ctypes.c_int
    lib.sg_tracker_track_mono.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.sg_tracker_keyframe_points.restype = ctypes.c_int
    lib.sg_tracker_keyframe_points.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    for fn in ("sg_tracker_window_poses", "sg_tracker_trajectory"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_int
        f.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
        ]
    lib.sg_tracker_poll_loop.restype = ctypes.c_int
    lib.sg_tracker_poll_loop.argtypes = [ctypes.c_void_p]
    lib.sg_tracker_feed_imu.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.sg_tracker_imu_delta.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.sg_tracker_set_gravity.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
    ]
    lib.sg_tracker_set_gt_hint.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
    ]
    lib.sg_tracker_map_info.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.sg_tracker_pr_stats.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
    ]
    lib.sg_tracker_imu_init_state.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
    ]
    lib.sg_tracker_imu_accel_bias.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
    ]
    lib.sg_tracker_poll_scale.restype = ctypes.c_double
    lib.sg_tracker_poll_scale.argtypes = [ctypes.c_void_p]
    lib.sg_tracker_destroy.argtypes = [ctypes.c_void_p]
    return lib


def library_path() -> Path:
    """The path of the loaded library (built on first use)."""
    return Path(_load()._name)


def native_available() -> bool:
    """Whether the library builds and loads here (for tests' skip marks;
    the apps call the library and let a failed build raise)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


class NativeLoader:
    """Threaded decode+undistort pipeline over a list of frame paths."""

    def __init__(self, rgb_paths, depth_paths=None, depth_scale: float = 1.0,
                 n_threads: int = 4, dist_coeffs=None, intrinsics=None):
        lib = _load()
        self._lib = lib
        n = len(rgb_paths)
        rgb_arr = (ctypes.c_char_p * n)(
            *[str(p).encode() for p in rgb_paths]
        )
        if depth_paths is not None:
            depth_arr = (ctypes.c_char_p * n)(
                *[str(p).encode() if p else None for p in depth_paths]
            )
        else:
            depth_arr = None
        self._h = lib.sg_loader_create(
            ctypes.cast(rgb_arr, ctypes.POINTER(ctypes.c_char_p)),
            ctypes.cast(depth_arr, ctypes.POINTER(ctypes.c_char_p))
            if depth_arr
            else None,
            n, depth_scale, n_threads,
        )
        w, h = ctypes.c_int(), ctypes.c_int()
        lib.sg_loader_dims(self._h, ctypes.byref(w), ctypes.byref(h))
        self.width, self.height = w.value, h.value
        self._n = n
        if dist_coeffs is not None and any(dist_coeffs):
            fx, fy, cx, cy = intrinsics
            d = (ctypes.c_double * 5)(*dist_coeffs)
            lib.sg_loader_set_undistort(self._h, fx, fy, cx, cy, d)

    def __iter__(self):
        rgb = np.empty((self.height, self.width, 3), np.float32)
        depth = np.empty((self.height, self.width), np.float32)
        has_depth = ctypes.c_int()
        while True:
            idx = self._lib.sg_loader_next(
                self._h,
                rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.byref(has_depth),
            )
            if idx == -1:
                return
            if idx == -2:
                continue
            yield idx, rgb.copy(), (depth.copy() if has_depth.value else None)

    def close(self):
        if self._h:
            self._lib.sg_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeTracker:
    """RGB-D ORB + PnP visual odometry (see tracker.cpp)."""

    TRACKED = 0
    NEW_KEYFRAME = 1
    LOST = -1

    def __init__(self, fx, fy, cx, cy, n_features: int = 1500):
        self._lib = _load()
        self._h = self._lib.sg_tracker_create(fx, fy, cx, cy, n_features)

    def track(self, gray_u8: np.ndarray, depth_f32: np.ndarray):
        """Returns (status, pose7 (tx,ty,tz,qw,qx,qy,qz), n_inliers)."""
        h, w = gray_u8.shape
        gray_u8 = np.ascontiguousarray(gray_u8, np.uint8)
        depth_f32 = np.ascontiguousarray(depth_f32, np.float32)
        pose = (ctypes.c_double * 7)()
        n_inl = ctypes.c_int()
        status = self._lib.sg_tracker_track(
            self._h,
            gray_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            depth_f32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            w, h, pose, ctypes.byref(n_inl),
        )
        return status, np.array(pose[:7]), n_inl.value

    def track_stereo(self, gray_l_u8: np.ndarray, gray_r_u8: np.ndarray,
                     baseline: float):
        """Native rectified-stereo tracking (tracker.cpp
        sg_tracker_track_stereo): ORB left-right row matching -> per-feature
        metric depth + dense BM depth. Returns (status, pose7, n_inliers)."""
        h, w = gray_l_u8.shape
        gl = np.ascontiguousarray(gray_l_u8, np.uint8)
        gr = np.ascontiguousarray(gray_r_u8, np.uint8)
        pose = (ctypes.c_double * 7)()
        n_inl = ctypes.c_int()
        status = self._lib.sg_tracker_track_stereo(
            self._h,
            gl.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            gr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            w, h, ctypes.c_double(float(baseline)), pose,
            ctypes.byref(n_inl),
        )
        return status, np.array(pose[:7]), n_inl.value

    def track_mono(self, gray_u8: np.ndarray):
        """Monocular tracking: (status, pose7, n_inliers). status -1 while
        the two-view bootstrap gathers parallax; map scale is arbitrary."""
        h, w = gray_u8.shape
        gray_u8 = np.ascontiguousarray(gray_u8, np.uint8)
        pose = (ctypes.c_double * 7)()
        n_inl = ctypes.c_int()
        status = self._lib.sg_tracker_track_mono(
            self._h,
            gray_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            w, h, pose, ctypes.byref(n_inl),
        )
        return status, np.array(pose[:7]), n_inl.value

    def keyframe_points(self, max_n: int = 2000):
        """(n, 5) rows of (u, v, x, y, z) for the last keyframe."""
        buf = np.empty((max_n, 5), np.float32)
        n = self._lib.sg_tracker_keyframe_points(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_n
        )
        return buf[:n].copy()

    def _poses(self, fn, max_n):
        ids = np.empty(max_n, np.int32)
        frame_nos = np.empty(max_n, np.int32)
        poses = np.empty((max_n, 7), np.float64)
        n = fn(
            self._h,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            frame_nos.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            poses.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            max_n,
        )
        return ids[:n].copy(), frame_nos[:n].copy(), poses[:n].copy()

    def window_poses(self, max_n: int = 16):
        """Post-BA poses of the current keyframe window: (kf_ids, frame_nos,
        (n,7) poses as tx ty tz qw qx qy qz world-to-camera)."""
        return self._poses(self._lib.sg_tracker_window_poses, max_n)

    def trajectory(self, max_n: int = 100_000):
        """All keyframe poses (post-BA / post-loop-correction)."""
        return self._poses(self._lib.sg_tracker_trajectory, max_n)

    def poll_loop(self) -> int:
        """Candidate kf id of the latest loop closure since the last poll,
        or -1. A non-negative value means the trajectory was corrected."""
        return self._lib.sg_tracker_poll_loop(self._h)

    def feed_imu(self, dt: float, gyro, accel):
        """Feed one body-frame IMU sample covering `dt` seconds. Samples
        preintegrate until the next accepted track() frame (reference:
        ORB-SLAM3 ImuTypes.cc IntegrateNewMeasurement)."""
        g = (ctypes.c_double * 3)(*[float(v) for v in gyro])
        a = (ctypes.c_double * 3)(*[float(v) for v in accel])
        self._lib.sg_tracker_feed_imu(self._h, float(dt), g, a)

    def imu_delta(self):
        """Current preintegrated (dR 3x3, dv 3, dp 3), gravity-free, in the
        body frame at the last accepted frame."""
        dR = (ctypes.c_double * 9)()
        dv = (ctypes.c_double * 3)()
        dp = (ctypes.c_double * 3)()
        self._lib.sg_tracker_imu_delta(self._h, dR, dv, dp)
        return (np.array(dR[:9]).reshape(3, 3), np.array(dv[:3]),
                np.array(dp[:3]))

    def set_gravity(self, g_w):
        """World gravity vector (default (0, +9.81, 0): +y down)."""
        g = (ctypes.c_double * 3)(*[float(v) for v in g_w])
        self._lib.sg_tracker_set_gravity(self._h, g)

    def pr_stats(self):
        """Place-recognition counters: (queries, descriptor-bag matches run,
        descriptors indexed). Sub-linearity surface for the inverted-index
        retrieval (tracker.cpp LshIndex)."""
        q = ctypes.c_long()
        m = ctypes.c_long()
        d = ctypes.c_long()
        self._lib.sg_tracker_pr_stats(self._h, ctypes.byref(q),
                                      ctypes.byref(m), ctypes.byref(d))
        return q.value, m.value, d.value

    def imu_init_state(self):
        """(gyro_bias[3], gravity_w[3], state) with state 0 = default
        gravity, 1 = online-estimated, 2 = externally set."""
        b = (ctypes.c_double * 3)()
        g = (ctypes.c_double * 3)()
        s = ctypes.c_int()
        self._lib.sg_tracker_imu_init_state(self._h, b, g, ctypes.byref(s))
        return list(b), list(g), s.value

    def imu_accel_bias(self):
        """Current accel-bias estimate (zeros until the joint [gravity;
        accel-bias] refinement commits; tracker.cpp ba_N solve)."""
        b = (ctypes.c_double * 3)()
        self._lib.sg_tracker_imu_accel_bias(self._h, b)
        return list(b)

    def poll_scale(self) -> float:
        """Mono-inertial scale refinement factor, once (0.0 = none pending).
        The internal map was already rescaled by it; the caller forwards a
        SCALE_REFINEMENT MappingOperation so the gaussian map follows
        (reference: ORB-SLAM3/src/LocalMapping.cc:1296-1305)."""
        return float(self._lib.sg_tracker_poll_scale(self._h))

    def map_info(self):
        """Atlas state: (active_map, maps_created, merged_into_or_-1).
        The merge indicator clears on read (poll semantics); a non-negative
        value means the active map was just aligned onto an older one."""
        a = ctypes.c_int()
        c = ctypes.c_int()
        m = ctypes.c_int()
        self._lib.sg_tracker_map_info(self._h, ctypes.byref(a),
                                      ctypes.byref(c), ctypes.byref(m))
        return a.value, c.value, m.value

    def set_gt_hint(self, pose7):
        """Diagnostic (SG_ABL_FORCE_GT=1): ground-truth pose for the next
        track(); internal state adopts it, pose_out stays the estimate."""
        p = (ctypes.c_double * 7)(*[float(v) for v in pose7])
        self._lib.sg_tracker_set_gt_hint(self._h, p)

    def __del__(self):
        try:
            self._lib.sg_tracker_destroy(self._h)
        except Exception:
            pass
