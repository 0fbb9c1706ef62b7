"""Online mapper: consumes MappingOperations, trains the map continuously.

The GaussianMapper engine re-designed around an async host queue + jitted
train step (reference: GaussianMapper::run / combineMappingOperations /
handleNewKeyframe / trainForOneIteration, src/gaussian_mapper.cpp:523-1421):

  PHASE 1  wait until the tracker has produced >= min_num_initial_map_kfs
           keyframes, snapshot them, seed anchors from the sparse points
           (reference :523-668)
  PHASE 2  loop { drain ops -> refresh poses / add keyframes / insert
           points; train one iteration } until the producer closes
           (reference :670-768)
  PHASE 3  tail optimization on the final keyframe set (reference :770-779)

Where the reference syncs the GPU every iteration, here train steps are
enqueued on the device without a sync; the host reads the device only every
100 iterations (the metrics) and inside densification.

Port of segs_slam_tpu/slam/mapper.py over the port's Trainer.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np

from segs_slam_tpu_torch.core.camera import Camera
from segs_slam_tpu_torch.core.keyframe import Keyframe
from segs_slam_tpu_torch.slam.protocol import (
    MappingOperation,
    MappingQueue,
    OperationKind,
)
from segs_slam_tpu_torch.slam import frontends
from segs_slam_tpu_torch.train.trainer import Trainer
from segs_slam_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """Mapper.* yaml keys (reference: readConfigFromFile,
    src/gaussian_mapper.cpp:326-366)."""

    min_num_initial_map_kfs: int = 10
    new_keyframe_times_of_use: int = 8
    local_ba_increased_times_of_use: int = 0
    loop_closure_increased_times_of_use: int = 2
    cull_keyframes: bool = False
    inactive_geo_densify: bool = False
    # photometric keyframe-pose refinement cadence (0 = off): every N train
    # iterations one keyframe pose is optimized through the differentiable
    # renderer (absorbs tracker pose error; beyond reference scope)
    pose_refine_every: int = 0
    pose_refine_warmup: int = 500
    # frame-to-model alignment (0 = off): LM photometric refinement of each
    # NEW keyframe's pose against the current map, before it trains or
    # densifies — corrects tracker pose error before it can blur the map
    # (the round-3 ablation showed pose error costs ~3 dB; continuous joint
    # pose optimization random-walks, so correction must be bounded)
    pose_refine_on_arrival: int = 0
    depth_cache: int = 10
    min_depth: float = 1e-10
    max_depth: float = 40.0
    tail_iterations: int = 0  # light-mode tail optimization budget
    # shutdown pose refinement (0 = off): after the training budget, run N
    # rounds of {re-estimate EVERY keyframe pose against the now-converged
    # map (photometric+depth LM, full resolution), then re-fit the map for
    # `shutdown_pose_refine_iters` train iterations}. Offline, so the
    # online-equilibrium objection to on-arrival alignment (RESULTS.md
    # finding 4) does not apply: re-aligning all keyframes to the common
    # consensus removes the medium-range relative inconsistency that blurs
    # the map, and the re-fit lets the map sharpen onto the now-consistent
    # poses. Reference slot: pose refreshes after BA,
    # ORB-SLAM3/src/LocalMapping.cc:149-160.
    shutdown_pose_refine_rounds: int = 0
    shutdown_pose_refine_steps: int = 8
    shutdown_pose_refine_iters: int = 400


class Mapper:
    def __init__(
        self,
        queue: MappingQueue,
        trainer: Trainer,
        camera: Camera,
        config: MapperConfig = MapperConfig(),
    ):
        self.queue = queue
        self.trainer = trainer
        self.camera = camera
        self.config = config
        self.initialized = False
        self.stopped = False  # hard abort
        self.producer_done = False  # tracker finished; keep training budget
        self.loop_closure_iteration = False
        self._depth_point_cache: list[np.ndarray] = []
        self._cached_frames = 0
        self._refine_rr = 0
        # with debug_ckpt_at > 0, the train state is saved to
        # debug_ckpt_path (io/checkpoint.py) after that iteration
        self.debug_ckpt_at = 0
        self.debug_ckpt_path: Path | None = None

    # --- keyframe ingestion (reference: handleNewKeyframe :1312-1421) ---
    def _handle_new_keyframe(self, kfd) -> None:
        kf = Keyframe(
            kf_id=kfd.kf_id,
            camera=self.camera,
            quat=kfd.quat,
            trans=kfd.trans,
            image=kfd.image,
            depth=kfd.depth,
            timestamp=kfd.timestamp,
        )
        if self.config.pose_refine_on_arrival and self.initialized:
            # frame-to-model alignment against the current map BEFORE the
            # keyframe trains or seeds geometry (see MapperConfig)
            self.trainer.refine_keyframe_pose(
                kf, steps=self.config.pose_refine_on_arrival)
        self.trainer.add_keyframe(kf)
        if kfd.is_loop_kf:
            kf.remaining_times_of_use += (
                self.config.loop_closure_increased_times_of_use
            )
        if self.config.inactive_geo_densify:
            self._inactive_geo_densify(kfd)

    def _inactive_geo_densify(self, kfd) -> None:
        """Per-sensor sparse->dense point harvest, cached then inserted every
        depth_cache keyframes (reference: :1544-1731)."""
        pts = None
        if kfd.depth is not None:  # RGB-D
            pts = frontends.backproject_depth(
                kfd.depth, self.camera, kfd.quat, kfd.trans,
                self.config.min_depth, self.config.max_depth,
            )
        elif kfd.keypoint_pixels is not None:  # monocular
            pts = frontends.mono_neighborhood_densify(
                kfd.keypoint_pixels, kfd.keypoint_points, self.camera,
                kfd.quat, kfd.trans,
            )
        if pts is not None and len(pts):
            self._depth_point_cache.append(pts)
            self._cached_frames += 1
        if self._cached_frames >= self.config.depth_cache:
            allpts = np.concatenate(self._depth_point_cache, axis=0)
            self.trainer.insert_points(allpts)
            self._depth_point_cache.clear()
            self._cached_frames = 0

    # --- op handling (reference: combineMappingOperations :1066-1206) ---
    def _apply_operation(self, op: MappingOperation) -> None:
        if op.kind == OperationKind.LOCAL_MAPPING_BA:
            for kfd in op.keyframes:
                existing = self.trainer.scene.keyframes.get(kfd.kf_id)
                if existing is not None:
                    self.trainer.set_keyframe_pose(existing, kfd.quat,
                                                   kfd.trans)
                    existing.remaining_times_of_use += (
                        self.config.local_ba_increased_times_of_use
                    )
                else:
                    self._handle_new_keyframe(kfd)
            for kid, (q, t) in op.pose_updates.items():
                kf = self.trainer.scene.keyframes.get(kid)
                if kf is not None:
                    self.trainer.set_keyframe_pose(kf, q, t)
            if op.points_xyz is not None and len(op.points_xyz) >= 30:
                if self.initialized:
                    self.trainer.insert_points(np.asarray(op.points_xyz))
                if op.point_ids is not None:
                    self.trainer.scene.cache_points(
                        op.point_ids, np.asarray(op.points_xyz)
                    )
            if self.config.cull_keyframes and op.live_keyframe_ids:
                self.trainer.scene.cull_keyframes(set(op.live_keyframe_ids))
        elif op.kind == OperationKind.LOOP_CLOSING_BA:
            for kid, (q, t) in op.pose_updates.items():
                kf = self.trainer.scene.keyframes.get(kid)
                if kf is not None:
                    self.trainer.set_keyframe_pose(kf, q, t)
                    kf.remaining_times_of_use += (
                        self.config.loop_closure_increased_times_of_use
                    )
            self.loop_closure_iteration = True
        elif op.kind == OperationKind.SCALE_REFINEMENT:
            # scale + rigid correction of map and poses (reference
            # :1165-1196 + operate_points.cu); anchors are corrected too.
            s, T = op.scale, op.transform
            self.trainer.apply_similarity(T, s)
            for kid, (q, t) in op.pose_updates.items():
                kf = self.trainer.scene.keyframes.get(kid)
                if kf is not None:
                    self.trainer.set_keyframe_pose(kf, q, t)

    def _try_initialize(self, op: MappingOperation) -> None:
        self._apply_operation(op)
        scene = self.trainer.scene
        if len(scene.keyframes) >= self.config.min_num_initial_map_kfs:
            pts = (
                np.stack(list(scene.cached_points.values()))
                if scene.cached_points
                else np.zeros((0, 3))
            )
            if len(pts) == 0:
                return
            n = self.trainer.initialize_map(pts)
            self.initialized = True
            print(f"[mapper] initialized with {n} anchors "
                  f"from {len(pts)} points, {len(scene.keyframes)} kfs")

    # --- main loop (reference: run() :523-795: keeps training after SLAM
    # shutdown until the iteration budget, then tail-optimizes) ---
    def run(self, max_iterations: int | None = None, idle_sleep: float = 0.002):
        # the pop waits up to 10 ms for an operation, except after a pass
        # that trained: then the loop has work, and takes only what is there
        wait = True
        while not self.stopped:
            if max_iterations is not None and self.trainer.iteration >= max_iterations:
                break
            tracing.peak("mapper.queue_depth_max", self.queue.qsize())
            with tracing.span("mapper.queue_wait"):
                op = self.queue.pop(timeout=0.01 if wait else 0.0)
            if not wait:
                tracing.count("mapper.pops_unwaited", 1)
            if op is not None:
                tracing.count("mapper.ops", 1)
                with tracing.span("mapper.apply_op"):
                    if not self.initialized:
                        self._try_initialize(op)
                        continue
                    self._apply_operation(op)
            if not self.initialized:
                if self.producer_done and not self.queue.has_operation():
                    break  # producer ended before enough keyframes arrived
                continue
            m = self.trainer.train_iteration()
            wait = m is None
            if (self.config.pose_refine_every
                    and self.trainer.iteration >= self.config.pose_refine_warmup
                    and self.trainer.iteration % self.config.pose_refine_every
                    == 0):
                kfs = list(self.trainer.scene.keyframes.values())
                if kfs:
                    kf = kfs[self._refine_rr % len(kfs)]
                    self._refine_rr += 1
                    self.trainer.refine_keyframe_pose(kf)
            if (self.debug_ckpt_at and
                    self.trainer.iteration == self.debug_ckpt_at):
                from segs_slam_tpu_torch.io.checkpoint import save_train_state

                if self.debug_ckpt_path is None:
                    raise ValueError("debug_ckpt_at needs a debug_ckpt_path")
                save_train_state(self.debug_ckpt_path, self.trainer.state)
                print(f"[mapper] saved debug ckpt at "
                      f"{self.trainer.iteration}", flush=True)
            if m is not None and self.trainer.iteration % 100 == 0:
                # the operator's warnings: the one host read of the device
                # in a hundred iterations
                with tracing.span("mapper.log"):
                    self._warn(m)
            if op is None and m is None:
                if self.producer_done and not self.queue.has_operation():
                    break
                with tracing.span("mapper.idle"):
                    time.sleep(idle_sleep)

        # PHASE 2.5: shutdown pose refinement (see MapperConfig)
        if self.initialized:
            for r in range(self.config.shutdown_pose_refine_rounds):
                # round 0 coarse (pooled, wide basin), later rounds full-res
                pool = 4 if r == 0 else 1
                total = 0.0
                for kf in list(self.trainer.scene.keyframes.values()):
                    total += self.trainer.refine_keyframe_pose(
                        kf, steps=self.config.shutdown_pose_refine_steps,
                        pool=pool)
                print(f"[mapper] shutdown pose refine round {r} (pool={pool})"
                      f": total loss improvement {total:.4f}", flush=True)
                for _ in range(self.config.shutdown_pose_refine_iters):
                    self.trainer.train_iteration()

        # PHASE 3: tail optimization
        for _ in range(self.config.tail_iterations):
            self.trainer.train_iteration()

    def _warn(self, m: dict) -> None:
        """Prints non-finite gradients, loss or anchors, and visible
        gaussians dropped beyond the compaction capacity."""
        loss = float(m["loss"])
        nfg = int(m.get("nonfinite_grads", 0))
        anchor_sum = float(self.trainer.state.anchors.anchor.sum())
        if nfg or not (np.isfinite(loss) and np.isfinite(anchor_sum)):
            print(f"[mapper] iter {self.trainer.iteration}: "
                  f"nonfinite_grads={nfg} loss={loss} "
                  f"anchor_sum={anchor_sum}", flush=True)
        nc = int(m.get("num_compact", 0))
        if nc > self.trainer.raster_config.compact:
            print(f"[mapper] WARNING iter {self.trainer.iteration}: "
                  f"{nc} visible gaussians exceed compact capacity "
                  f"{self.trainer.raster_config.compact}; overflow "
                  "dropped", flush=True)

    def signal_stop(self):
        """Producer finished: training continues to the budget
        (reference keeps optimizing after SLAM shutdown)."""
        self.producer_done = True

    def abort(self):
        self.stopped = True
