"""Offline trainer, the `trainColmap` equivalent.

Port of segs_slam_tpu/train/trainer.py: drives the train step over a fixed
keyframe set with the mapper's sliding-window sampler and periodic anchor
adjustment (reference: GaussianMapper::trainColmap,
src/gaussian_mapper.cpp:797-820 + trainForOneIteration :823-1031). Steps are
enqueued on the device without host syncs; the host reads the device only
at log points and inside densification.

Evaluation (`evaluate`, `render_keyframe`, `render_and_measure_keyframe`)
renders through `EvalRenderer`: the packed eval binning and kernel K3, with
the tier sizes calibrated on the map's own footprints.

Not ported yet: in-step pose optimisation (`optimize_poses`, pose rows and
pose deltas, `refine_keyframe_pose`, `fold_pose_deltas`: the SLAM slice) and
Gaussian-pyramid levels. Without pose deltas a keyframe renders at its own
pose, where the JAX Trainer's `refined_cam` would add the delta.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from segs_slam_tpu_torch.core import se3
from segs_slam_tpu_torch.core.keyframe import Keyframe
from segs_slam_tpu_torch.io.ply import save_anchor_ply
from segs_slam_tpu_torch.models.anchors import empty_state, insert_points
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.models.decoders import Decoders
from segs_slam_tpu_torch.models.renderer import (
    EvalRenderer,
    calibrate_eval_config,
)
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from segs_slam_tpu_torch.slam.scene import Scene
from segs_slam_tpu_torch.train import losses
from segs_slam_tpu_torch.train.config import OptimizationConfig
from segs_slam_tpu_torch.train.densify import make_adjust_anchor
from segs_slam_tpu_torch.train.step import (
    TrainState,
    init_train_state,
    make_train_step,
)


@dataclass
class Trainer:
    model_config: ModelConfig
    opt_config: OptimizationConfig
    raster_config: RasterConfig
    width: int
    height: int
    white_background: bool = False
    seed: int = 0
    keyframe_times_of_use: int = 8  # Mapper.new_keyframe_times_of_use
    device: str = "cuda"

    scene: Scene = field(init=False)
    state: TrainState = field(init=False, default=None)
    iteration: int = field(init=False, default=0)

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.scene = Scene(seed=self.seed)
        self._bg = torch.full((3,), 1.0 if self.white_background else 0.0,
                              device=self.device)
        self._build_step()
        # densification's candidate draws
        self._generator = torch.Generator(device=self.device).manual_seed(
            self.seed)
        self._cam_cache: dict[int, dict] = {}
        self._gt_cache: dict[int, torch.Tensor] = {}
        # sensor-depth planes for lambda_depth (zeros for a keyframe with
        # no depth)
        self._depth_cache: dict[int, torch.Tensor] = {}
        self._eval_renderer: EvalRenderer | None = None

    def _build_step(self):
        self._step = make_train_step(self.model_config, self.opt_config,
                                     self.raster_config, self.width,
                                     self.height)
        self._adjust = make_adjust_anchor(self.model_config, self.opt_config)

    # --- setup ---
    def add_keyframe(self, kf: Keyframe) -> None:
        kf.remaining_times_of_use = self.keyframe_times_of_use
        self.scene.add_keyframe(kf)
        self._cam_cache.pop(kf.kf_id, None)
        self._gt_cache.pop(kf.kf_id, None)
        self._depth_cache.pop(kf.kf_id, None)

    def initialize_map(self, points: np.ndarray,
                       decoders: Decoders | None = None) -> int:
        """Seed the map from `points` and start a fresh train state. The
        decoders are initialised from `seed` unless given (a test passes the
        JAX package's initial weights)."""
        # cameras_extent -> spatial_lr_scale (reference: getNerfppNorm
        # radius feeding trainingSetup, src/gaussian_mapper.cpp:651-654);
        # the schedules bake the scale in, so the step is rebuilt
        if self.scene.keyframes:
            radius = self.scene.nerfpp_norm_radius()
            self.opt_config = dataclasses.replace(self.opt_config,
                                                  spatial_lr_scale=radius)
            self._build_step()
        anchors, n = insert_points(
            empty_state(self.model_config, self.device), points,
            self.model_config)
        if decoders is None:
            decoders = Decoders(
                self.model_config,
                generator=torch.Generator(device=self.device).manual_seed(
                    self.seed),
                device=self.device)
        self.state = init_train_state(anchors, decoders.to(self.device),
                                      self.model_config)
        return n

    def insert_points(self, points: np.ndarray) -> int:
        anchors, n = insert_points(self.state.anchors, points,
                                   self.model_config)
        self.state.anchors = anchors
        return n

    def apply_similarity(self, transform: np.ndarray | None,
                         scale: float) -> None:
        """Similarity correction of the map (scale refinement / loop close,
        reference: scaleAndTransformThenMarkVisiblePoints,
        src/operate_points.cu:96-143). Applies p' = R (s p) + t to anchors
        and cached points, log-scales the anchor scalings, rotates the
        learned per-anchor offsets (they decode in world axes:
        xyz = anchor + offset * exp(scaling[:, :3])) and composes the anchor
        rotations with R."""
        T = np.eye(4) if transform is None else np.asarray(transform)
        for pid, p in list(self.scene.cached_points.items()):
            self.scene.cached_points[pid] = (
                T[:3, :3] @ (scale * p) + T[:3, 3]).astype(np.float32)
        if self.state is None:
            return
        a = self.state.anchors
        R = torch.as_tensor(T[:3, :3], dtype=torch.float32,
                            device=self.device)
        t = torch.as_tensor(T[:3, 3], dtype=torch.float32,
                            device=self.device)
        # exact offset correction through the per-axis scale basis: world
        # offset = offset * exp(s3); rotate + scale it, then re-express in
        # the new basis exp(s3') = s * exp(s3)
        e3 = torch.exp(a.scaling[:, :3])
        off_world = (a.offset * e3[:, None, :] * scale) @ R.T
        new_offset = off_world / torch.clamp(e3[:, None, :] * scale,
                                             min=1e-12)
        q_r = se3.rotmat_to_quat(R)
        self.state.anchors = dataclasses.replace(
            a, anchor=(a.anchor * scale) @ R.T + t,
            scaling=a.scaling + float(np.log(scale)), offset=new_offset,
            rotation=se3.normalize_quat(se3.quat_mul(q_r[None, :],
                                                     a.rotation)))

    # --- training ---
    def _kf_inputs(self, kf: Keyframe):
        cam = self._cam_cache.get(kf.kf_id)
        if cam is None:
            cam = {k: torch.as_tensor(v, device=self.device)
                   for k, v in kf.render_inputs().items()}
            self._cam_cache[kf.kf_id] = cam
        gt = self._gt_cache.get(kf.kf_id)
        if gt is None:
            img = kf.image
            if img.shape[0] != 3:  # HWC -> CHW
                img = np.transpose(img, (2, 0, 1))
            gt = torch.as_tensor(np.asarray(img, np.float32),
                                 device=self.device)
            self._gt_cache[kf.kf_id] = gt
        return cam, gt

    def train_iteration(self):
        """One step on the next sliding-window keyframe (and densification
        when due). Returns the step's metrics, on the device, or None when
        the scene has no keyframe."""
        kf = self.scene.sample_sliding_window_keyframe()
        if kf is None:
            return None
        self.iteration += 1
        cam, gt = self._kf_inputs(kf)
        gt_depth = None
        if self.opt_config.lambda_depth > 0.0:
            gt_depth = self._depth_cache.get(kf.kf_id)
            if gt_depth is None:
                gt_depth = torch.as_tensor(
                    np.asarray(kf.depth if kf.depth is not None
                               else np.zeros((self.height, self.width)),
                               np.float32), device=self.device)
                self._depth_cache[kf.kf_id] = gt_depth
        self.state, metrics = self._step(self.state, cam, gt, self._bg,
                                         gt_depth=gt_depth)

        oc = self.opt_config
        it = self.iteration
        if oc.update_from < it < oc.update_until \
                and it % oc.update_interval == 0:
            self.state = self._adjust(self.state, self._generator)
        return metrics

    def train(self, iterations: int, log_every: int = 0, log_fn=print,
              history: list | None = None):
        """Run `iterations` steps; returns the last step's metrics. With
        `history`, each step's loss tensor is appended to it (left on the
        device: no sync)."""
        last = None
        t0 = time.time()
        for _ in range(iterations):
            m = self.train_iteration()
            if m is None:
                break
            last = m
            if history is not None:
                history.append(m["loss"])
            if log_every and self.iteration % log_every == 0:
                mm = {k: float(v) for k, v in m.items()}  # syncs the device
                dt = (time.time() - t0) * 1000 / log_every
                t0 = time.time()
                log_fn(f"iter {self.iteration}: loss={mm['loss']:.4f} "
                       f"psnr={mm['psnr']:.2f} active={int(mm['n_active'])} "
                       f"({dt:.1f} ms/iter)")
                self._warn_capacity(mm, log_fn)
        return last

    def _warn_capacity(self, mm: dict, log_fn=print) -> None:
        """Surface silent static-capacity truncations: visible gaussians
        beyond RasterConfig.compact are dropped with their gradients;
        footprints beyond kmax tiles are shrunk."""
        nc = mm.get("num_compact")
        if nc is not None and nc > self.raster_config.compact:
            log_fn(f"WARNING: {int(nc)} visible gaussians exceed the "
                   f"compaction capacity {self.raster_config.compact}; "
                   "overflow is dropped (raise RasterConfig.compact)")
        nt = mm.get("num_kmax_truncated")
        if nt:
            log_fn(f"note: {int(nt)} gaussian footprints truncated to "
                   f"kmax={self.raster_config.kmax} tiles")

    # --- evaluation (reference: renderAndRecordKeyframe,
    # src/gaussian_mapper.cpp:1769-1907) ---
    def eval_renderer(self) -> EvalRenderer:
        """The cached EvalRenderer: RasterConfig.eval_variant with its tier
        prefixes calibrated on up to four keyframes' views. As in the JAX
        Trainer, the calibration runs once, at the first evaluation, and is
        not redone when the map grows or densifies (`reset_eval_renderer`
        drops it)."""
        if self._eval_renderer is None:
            kfs = [kf for _, kf in sorted(self.scene.keyframes.items())]
            cams = [self._kf_inputs(kf)[0]
                    for kf in kfs[::max(1, len(kfs) // 4)][:4]]
            rc = calibrate_eval_config(
                self.raster_config, self.model_config, self.state.anchors,
                self.state.decoders, cams, self.width, self.height,
            ) if cams else self.raster_config.eval_variant(self.width,
                                                           self.height)
            self._eval_renderer = EvalRenderer(
                self.model_config, rc, self.width, self.height, self._bg,
                device=self.device)
        return self._eval_renderer

    def reset_eval_renderer(self) -> None:
        """Drop the cached EvalRenderer: the next evaluation calibrates
        anew."""
        self._eval_renderer = None

    def render_keyframe(self, kf: Keyframe) -> torch.Tensor:
        """The keyframe's (3, H, W) eval render."""
        cam, _ = self._kf_inputs(kf)
        return self.eval_renderer()(self.state.anchors, self.state.decoders,
                                    cam)

    def render_and_measure_keyframe(self, kf: Keyframe):
        """(masked image, psnr, ssim, psnr_gs) of the keyframe's eval
        render, as device tensors (no host sync). The mask keeps the pixels
        where the ground truth is not black."""
        img = self.render_keyframe(kf)
        _, gt = self._kf_inputs(kf)
        with torch.no_grad():
            mask = (gt != 0.0).any(dim=0, keepdim=True).float()
            img_m, gt_m = img * mask, gt * mask
            return (img_m, losses.psnr(img_m, gt_m), losses.ssim(img_m, gt_m),
                    losses.psnr_gaussian_splatting(img_m, gt_m))

    def evaluate(self) -> dict:
        """Masked PSNR, SSIM and the per-channel PSNR over all keyframes;
        one host sync at the end."""
        outs = [torch.stack(self.render_and_measure_keyframe(kf)[1:])
                for kf in self.scene.keyframes.values()]
        vals = torch.stack(outs).cpu().numpy().astype(np.float64)
        return {
            "psnr": float(vals[:, 0].mean()),
            "ssim": float(vals[:, 1].mean()),
            "psnr_gs": float(vals[:, 2].mean()),
            "n_keyframes": len(outs),
        }

    def save_ply(self, path) -> None:
        a = self.state.anchors
        n = int(a.num_active())
        save_anchor_ply(path, *(x[:n].detach().cpu().numpy() for x in (
            a.anchor, a.feat, a.offset, a.opacity, a.scaling, a.rotation)))
