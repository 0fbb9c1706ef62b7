"""The SLAM -> mapper MappingOperation protocol.

Python dataclass form of the one-way bridge the reference adds to ORB-SLAM3's
Atlas (reference: ORB-SLAM3/include/Atlas.h:53-199 `MappingOperation`,
pushed by LocalMapping.cc:149-160 / LoopClosing.cc:1201 and consumed by
GaussianMapper::combineMappingOperations, src/gaussian_mapper.cpp:1066-1206).

Any tracking frontend (the bundled dataset oracle, a recorded-stream replay,
or a native ORB-SLAM3-style tracker) produces these; the mapper consumes them
from a thread-safe queue. Serialization is plain numpy-in-dataclasses so the
stream can be recorded to / replayed from disk (the fake producer of
SURVEY §4's test strategy).

Copy of segs_slam_tpu/slam/protocol.py.
"""

from __future__ import annotations

import dataclasses
import enum
import pickle
import queue
from pathlib import Path
from typing import Iterable

import numpy as np


class OperationKind(enum.IntEnum):
    """reference: Atlas.h MappingOperation::OprType (LocalMappingBA=1,
    LoopClosingBA=2, ScaleRefinement=3)."""

    LOCAL_MAPPING_BA = 1
    LOOP_CLOSING_BA = 2
    SCALE_REFINEMENT = 3


@dataclasses.dataclass
class KeyframeData:
    """Per-keyframe payload of a MappingOperation (the tuple of
    Atlas.h:89-133: id, camera id, pose, images, keypoints, intrinsics...)."""

    kf_id: int
    camera_id: int
    quat: np.ndarray  # (4,) w,x,y,z world-to-camera
    trans: np.ndarray  # (3,)
    image: np.ndarray | None = None  # (H, W, 3) float32 [0,1] undistorted RGB
    depth: np.ndarray | None = None  # (H, W) float32 (RGB-D aux image)
    keypoint_pixels: np.ndarray | None = None  # (n, 2) undistorted
    keypoint_points: np.ndarray | None = None  # (n, 3) camera-local 3D
    timestamp: float = 0.0
    is_loop_kf: bool = False


@dataclasses.dataclass
class MappingOperation:
    kind: OperationKind
    keyframes: list[KeyframeData] = dataclasses.field(default_factory=list)
    # new sparse map points (world frame) + colors, if any
    points_xyz: np.ndarray | None = None
    points_rgb: np.ndarray | None = None
    point_ids: np.ndarray | None = None
    # full pose refresh for already-known keyframes: {kf_id: (quat, trans)}
    pose_updates: dict = dataclasses.field(default_factory=dict)
    # scale refinement payload (mono-inertial)
    scale: float = 1.0
    transform: np.ndarray | None = None  # (4, 4) similarity correction
    # live keyframe ids (for culling)
    live_keyframe_ids: set = dataclasses.field(default_factory=set)


class MappingQueue:
    """Thread-safe producer/consumer queue — the equivalent of the
    Atlas mutex-guarded deque (Atlas.h:349-355)."""

    def __init__(self, maxsize: int = 0):
        self._q: queue.Queue[MappingOperation] = queue.Queue(maxsize=maxsize)

    def push(self, op: MappingOperation) -> None:
        self._q.put(op)

    def has_operation(self) -> bool:
        return not self._q.empty()

    def pop(self, timeout: float | None = None) -> MappingOperation | None:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def drain(self) -> list[MappingOperation]:
        ops = []
        while True:
            try:
                ops.append(self._q.get_nowait())
            except queue.Empty:
                return ops


def record_stream(ops: Iterable[MappingOperation], path: str | Path) -> None:
    with open(path, "wb") as f:
        for op in ops:
            pickle.dump(op, f, protocol=pickle.HIGHEST_PROTOCOL)


def replay_stream(path: str | Path):
    with open(path, "rb") as f:
        while True:
            try:
                yield pickle.load(f)
            except EOFError:
                return
