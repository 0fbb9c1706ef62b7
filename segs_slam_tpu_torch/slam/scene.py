"""Scene registry: cameras, keyframes, cached sparse points, and the
sliding-window keyframe sampler.

A copy of segs_slam_tpu/slam/scene.py, which is numpy-only but reaches JAX
through segs_slam_tpu/core/__init__.py. The sampler draws from Python's
random.Random(seed), so its keyframe order equals the JAX package's.

Host-side mapper state, mirroring GaussianScene + the mapper's keyframe
sampling (reference: src/gaussian_scene.cpp, include/gaussian_scene.h:35-81;
sampler: GaussianMapper::useOneRandomSlidingWindowKeyframe /
generateKfidRandomShuffle / increaseKeyframeTimesOfUse / cullKeyframes,
src/gaussian_mapper.cpp:1446-1543).
"""

from __future__ import annotations

import random
from typing import Iterable

import numpy as np

from segs_slam_tpu_torch.core.camera import Camera
from segs_slam_tpu_torch.core.keyframe import Keyframe


class Scene:
    def __init__(self, seed: int = 0):
        self.cameras: dict[int, Camera] = {}
        self.keyframes: dict[int, Keyframe] = {}
        self.cached_points: dict[int, np.ndarray] = {}  # point id -> xyz
        self.kfs_used_times: dict[int, int] = {}
        self._rng = random.Random(seed)
        self._shuffle: list[int] = []
        self._shuffle_idx = 0
        self._shuffled = False

    # --- registry ---
    def add_camera(self, cam: Camera) -> None:
        self.cameras[cam.camera_id] = cam

    def add_keyframe(self, kf: Keyframe) -> None:
        self.keyframes[kf.kf_id] = kf
        self._shuffled = False

    def cache_points(self, ids: Iterable[int], xyz: np.ndarray) -> None:
        for pid, p in zip(ids, xyz):
            self.cached_points[pid] = p

    # --- nerf++ normalization (reference: src/gaussian_scene.cpp:113-149) ---
    def nerfpp_norm_radius(self) -> float:
        centers = np.stack(
            [kf.camera_center for kf in self.keyframes.values()], axis=0
        )
        avg = centers.mean(axis=0)
        dists = np.linalg.norm(centers - avg, axis=1)
        return float(dists.max() * 1.1)

    # --- sliding-window sampler ---
    def _regenerate_shuffle(self) -> None:
        ids = list(self.keyframes.keys())
        self._rng.shuffle(ids)
        self._shuffle = ids
        self._shuffle_idx = 0
        self._shuffled = True

    def sample_sliding_window_keyframe(self) -> Keyframe | None:
        """Round-robin over a shuffled keyframe order, consuming
        times-of-use budgets; when every budget is exhausted, every keyframe
        gets one more use (the reference's wrap-around top-up,
        src/gaussian_mapper.cpp:1472-1480)."""
        if not self.keyframes:
            return None
        if not self._shuffled:
            self._regenerate_shuffle()
        # drop culled ids from the shuffle lazily
        self._shuffle = [i for i in self._shuffle if i in self.keyframes]
        if not self._shuffle:
            return None
        if self._shuffle_idx >= len(self._shuffle):
            self._shuffle_idx = 0

        start = self._shuffle_idx
        while True:
            self._shuffle_idx = (self._shuffle_idx + 1) % len(self._shuffle)
            if self._shuffle_idx == start:
                for kf in self.keyframes.values():
                    kf.remaining_times_of_use += 1
            kf = self.keyframes[self._shuffle[self._shuffle_idx]]
            if kf.remaining_times_of_use > 0:
                break
        kf.remaining_times_of_use -= 1
        self.kfs_used_times[kf.kf_id] = self.kfs_used_times.get(kf.kf_id, 0) + 1
        return kf

    def cull_keyframes(self, live_ids: set[int]) -> list[int]:
        """Drop keyframes the SLAM system no longer tracks
        (reference: cullKeyframes, src/gaussian_mapper.cpp:1526-1543)."""
        dead = [kid for kid in self.keyframes if kid not in live_ids]
        for kid in dead:
            del self.keyframes[kid]
        return dead
