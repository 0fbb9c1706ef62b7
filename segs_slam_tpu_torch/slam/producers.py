"""MappingOperation producers: the tracking side of the SLAM boundary.

Two producers ship in round 1:

  * DatasetOracleProducer — a SLAM stand-in that replays a dataset with its
    ground-truth poses, emitting keyframes + sparse "map points" subsampled
    from depth, exactly in the MappingOperation protocol (the fake-SLAM
    producer of SURVEY §4's test strategy; it also serves as the pose-oracle
    upper bound for mapping quality).
  * ReplayProducer — replays a recorded operation stream from disk, so the
    mapper is testable bit-for-bit without any tracker.

A native ORB-SLAM3-style visual tracker plugs in later by producing the same
dataclasses (reference bridge: Atlas::pushMappingOperation,
ORB-SLAM3/src/LocalMapping.cc:149-160).

Copy of segs_slam_tpu/slam/producers.py (numpy only).
"""

from __future__ import annotations

import threading

import numpy as np

from segs_slam_tpu_torch.core.camera import Camera
from segs_slam_tpu_torch.slam.protocol import (
    KeyframeData,
    MappingOperation,
    MappingQueue,
    OperationKind,
    replay_stream,
)
from segs_slam_tpu_torch.slam import frontends


class DatasetOracleProducer:
    def __init__(
        self,
        frames,  # list[io.datasets.Frame]
        camera: Camera,
        queue: MappingQueue,
        keyframe_every: int = 10,
        points_per_kf: int = 300,
        depth_scale: float = 6553.5,
        max_depth: float = 10.0,
        seed: int = 0,
    ):
        self.frames = frames
        self.camera = camera
        self.queue = queue
        self.keyframe_every = keyframe_every
        self.points_per_kf = points_per_kf
        self.depth_scale = depth_scale
        self.max_depth = max_depth
        self.rng = np.random.default_rng(seed)
        self.done = threading.Event()
        self._next_point_id = 0

    def _sparse_points(self, depth: np.ndarray, quat, trans) -> np.ndarray:
        pts = frontends.backproject_depth(
            depth, self.camera, quat, trans, 0.05, self.max_depth, stride=8
        )
        if len(pts) > self.points_per_kf:
            sel = self.rng.choice(len(pts), self.points_per_kf, replace=False)
            pts = pts[sel]
        return pts

    def run(self, start: int = 0, stop: int | None = None) -> None:
        stop = stop if stop is not None else len(self.frames)
        live_ids: set[int] = set()
        for i in range(start, stop, self.keyframe_every):
            fr = self.frames[i]
            rgb = fr.load_rgb()
            depth = fr.load_depth(self.depth_scale)
            kfd = KeyframeData(
                kf_id=i,
                camera_id=self.camera.camera_id,
                quat=np.asarray(fr.quat),
                trans=np.asarray(fr.trans),
                image=rgb,
                depth=depth,
                timestamp=fr.timestamp,
            )
            op = MappingOperation(kind=OperationKind.LOCAL_MAPPING_BA,
                                  keyframes=[kfd])
            if depth is not None:
                pts = self._sparse_points(depth, fr.quat, fr.trans)
                op.points_xyz = pts
                op.point_ids = np.arange(
                    self._next_point_id, self._next_point_id + len(pts)
                )
                self._next_point_id += len(pts)
            live_ids.add(i)
            op.live_keyframe_ids = set(live_ids)
            self.queue.push(op)
        self.done.set()

    def run_async(self, **kw) -> threading.Thread:
        t = threading.Thread(target=self.run, kwargs=kw, daemon=True)
        t.start()
        return t


class ReplayProducer:
    def __init__(self, path, queue: MappingQueue):
        self.path = path
        self.queue = queue
        self.done = threading.Event()

    def run(self) -> None:
        for op in replay_stream(self.path):
            self.queue.push(op)
        self.done.set()

    def run_async(self) -> threading.Thread:
        t = threading.Thread(target=self.run, daemon=True)
        t.start()
        return t


class SyntheticOracleProducer(DatasetOracleProducer):
    """Oracle producer over in-memory keyframes (no disk); used by the
    end-to-end mapper tests and the synthetic SLAM benchmark."""

    def __init__(self, keyframes, camera, queue, points_per_kf=300, seed=0,
                 sparse_points_fn=None):
        self.keyframes = keyframes
        self.camera = camera
        self.queue = queue
        self.points_per_kf = points_per_kf
        self.rng = np.random.default_rng(seed)
        self.done = threading.Event()
        self._next_point_id = 0
        self.sparse_points_fn = sparse_points_fn

    def run(self) -> None:
        live = set()
        for kf in self.keyframes:
            img = kf.image
            if img is not None and img.shape[0] == 3:
                img = np.transpose(img, (1, 2, 0))
            kfd = KeyframeData(
                kf_id=kf.kf_id,
                camera_id=self.camera.camera_id,
                quat=np.asarray(kf.quat),
                trans=np.asarray(kf.trans),
                image=img,
                depth=kf.depth,
                timestamp=kf.timestamp,
            )
            op = MappingOperation(kind=OperationKind.LOCAL_MAPPING_BA,
                                  keyframes=[kfd])
            if self.sparse_points_fn is not None:
                pts = np.asarray(self.sparse_points_fn(kf))
                op.points_xyz = pts
                op.point_ids = np.arange(
                    self._next_point_id, self._next_point_id + len(pts)
                )
                self._next_point_id += len(pts)
            live.add(kf.kf_id)
            op.live_keyframe_ids = set(live)
            self.queue.push(op)
        self.done.set()

    def run_async(self) -> threading.Thread:
        t = threading.Thread(target=self.run, daemon=True)
        t.start()
        return t


def fit_similarity(src: np.ndarray, dst: np.ndarray):
    """Umeyama similarity fit dst ~= s R src + t.

    Returns (s, T) with T a 4x4 rigid transform (R, t). Standard closed-form
    (the same alignment eval/metrics uses for scale-corrected mono ATE)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    t = mu_d - s * R @ mu_s
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return s, T


class ScaleDriftMonitor:
    """Detects monocular map-scale drift and produces SCALE_REFINEMENT ops.

    The reference only emits ScaleRefinement from IMU (LocalMapping.cc:
    1296-1305); a pure-mono tracker still drifts in scale, which the mapper
    otherwise absorbs photometrically (VERDICT r2 weak #7). This monitor
    records the camera centers the producer forwarded per keyframe; when the
    tracker's CURRENT centers for those keyframes fit a similarity with
    |log s| > tol against the recorded ones, it returns (s, T) so the
    producer can emit the op the mapper already handles
    (Mapper._apply_operation SCALE_REFINEMENT -> Trainer.apply_similarity).
    """

    def __init__(self, tol_log_scale: float = 0.02, min_kfs: int = 6):
        self.tol = tol_log_scale
        self.min_kfs = min_kfs
        self._sent: dict[int, np.ndarray] = {}  # frame id -> center at send

    @staticmethod
    def _center(quat, trans):
        w, x, y, z = quat
        R = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        return -R.T @ np.asarray(trans, np.float64)

    def record(self, frame_id: int, quat, trans) -> None:
        self._sent[frame_id] = self._center(quat, trans)

    def check(self, pose_updates: dict):
        """pose_updates: {frame_id: (quat, trans)} current tracker poses.
        Returns (s, T) on drift, else None. On detection the recorded
        centers are refreshed (the map is about to be corrected)."""
        common = [k for k in pose_updates if k in self._sent]
        if len(common) < self.min_kfs:
            return None
        src = np.stack([self._sent[k] for k in common])
        dst = np.stack([self._center(*pose_updates[k]) for k in common])
        if np.ptp(src, axis=0).max() < 1e-6:
            return None  # degenerate (no baseline)
        s, T = fit_similarity(src, dst)
        if not np.isfinite(s) or abs(np.log(max(s, 1e-12))) <= self.tol:
            return None
        # fit-quality gate: only a COHERENT similarity change (windowed BA /
        # loop correction rescaling history) should correct the map; a
        # tracking reset produces an incoherent trajectory change whose fit
        # residual is large relative to the new trajectory's extent — feeding
        # that into apply_similarity would corrupt the map (observed: a mono
        # re-bootstrap fit s=34 on synth_room)
        if abs(np.log(max(s, 1e-12))) > 1.2:
            return None  # >3x jump: that's a reset, never BA drift
        res = dst - (s * (T[:3, :3] @ src.T).T + T[:3, 3])
        rms = float(np.sqrt((res**2).sum(axis=1).mean()))
        extent = float(np.ptp(dst, axis=0).max())
        if extent < 1e-9 or rms > 0.12 * extent:
            return None
        for k in pose_updates:
            self._sent[k] = self._center(*pose_updates[k])
        return s, T

    def rebase(self, s: float) -> None:
        """The tracker rescaled its internal map by s (mono-inertial metric
        scale refinement) and the producer already forwarded the matching
        SCALE_REFINEMENT op; rescale the recorded centers so the deliberate
        jump is not re-detected as drift."""
        for k in self._sent:
            self._sent[k] = self._sent[k] * s


def tracker_pose_updates(fed_frames, frame_nos, poses7):
    """Map native-tracker frame ordinals to dataset frame ids (the mapper's
    keyframe ids) and convert pose7 rows (tx ty tz qw qx qy qz) to the
    protocol's (quat, trans) pairs. Ordinals outside the fed range are
    dropped (reference bridge: LocalMapping.cc:149-160 pose refreshes)."""
    updates = {}
    for fno, p in zip(frame_nos, poses7):
        if 0 <= fno < len(fed_frames):
            updates[fed_frames[fno]] = (p[3:7].copy(), p[0:3].copy())
    return updates
