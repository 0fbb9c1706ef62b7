"""The trainer: the `trainColmap` equivalent and the online mapper's engine.

Port of segs_slam_tpu/train/trainer.py: drives the train step over the
keyframe set with the mapper's sliding-window sampler and periodic anchor
adjustment (reference: GaussianMapper::trainColmap,
src/gaussian_mapper.cpp:797-820 + trainForOneIteration :823-1031). Steps are
enqueued on the device without host syncs; the host reads the device only
at log points and inside densification.

What the SLAM mapper needs besides: Gaussian-pyramid levels (coarse-to-fine
supervision, one step per level size), in-step pose optimisation (pose rows,
`set_keyframe_pose`, `refined_cam`, `fold_pose_deltas`) and photometric
keyframe-pose refinement (`refine_keyframe_pose`).

Evaluation (`evaluate`, `render_keyframe`, `render_and_measure_keyframe`)
renders through `EvalRenderer`: the packed eval binning and kernel K3, with
the tier sizes calibrated on the map's own footprints, at each keyframe's
pose composed with its learned delta.

The state is updated in place (Adam, the densify adjust's row
permutations), so `lock` guards it: the Trainer holds it across each train
iteration's step and adjust and across the map edits of the mapper's
operations, and a reader on another thread (the live viewer,
apps/viewer.py:serve_live) renders under it, as the reference renders
under the mapper's render mutex (src/gaussian_mapper.cpp:2484-2538).
"""

from __future__ import annotations

import dataclasses
import threading
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
    render,
)
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from segs_slam_tpu_torch.slam.scene import Scene
from segs_slam_tpu_torch.train import losses, optimizer
from segs_slam_tpu_torch.train.config import OptimizationConfig
from segs_slam_tpu_torch.train.densify import make_adjust_anchor
from segs_slam_tpu_torch.train.step import (
    TrainState,
    apply_pose_delta,
    init_train_state,
    make_train_step,
)
from segs_slam_tpu_torch.utils import tracing


def _so3_exp_np(w: np.ndarray) -> np.ndarray:
    """exp of a rotation vector in float64, |w| + 1e-12 as the angle (the
    JAX Trainer's host-side fold)."""
    th = np.linalg.norm(w) + 1e-12
    K = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]],
                  [-w[1], w[0], 0.0]])
    return (np.eye(3) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th**2 * (K @ K))


def _quat_f32(R: np.ndarray) -> np.ndarray:
    return se3.rotmat_to_quat(torch.as_tensor(R, dtype=torch.float32)).numpy()


def _pool(img: torch.Tensor, p: int) -> torch.Tensor:
    """p x p average pooling (p = 1: none); it widens the photometric basin
    of pose refinement."""
    if p <= 1:
        return img
    c, h, w = img.shape
    hp, wp = (h // p) * p, (w // p) * p
    return img[:, :hp, :wp].reshape(c, hp // p, p, wp // p, p).mean(
        dim=(2, 4))


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
    # Gaussian-pyramid coarse-to-fine supervision (reference: GausPyramid.*
    # keys + src/gaussian_mapper.cpp:837-859)
    num_pyramid_sub_levels: int = 0
    pyramid_times_of_use: int = 8
    # in-step photometric pose optimisation: per-keyframe SE3 tangent
    # deltas trained with the map (train/step.py apply_pose_delta). Rows
    # are assigned per keyframe in arrival order; keyframes beyond
    # max_pose_kfs train at their base pose.
    optimize_poses: bool = False
    max_pose_kfs: int = 512
    device: str = "cuda"

    scene: Scene = field(init=False)
    state: TrainState = field(init=False, default=None)
    iteration: int = field(init=False, default=0)

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.lock = threading.Lock()  # see the module docstring
        self.scene = Scene(seed=self.seed)
        self._bg = torch.full((3,), 1.0 if self.white_background else 0.0,
                              device=self.device)
        self._build_step()
        # densification's candidate draws
        self._generator = torch.Generator(device=self.device).manual_seed(
            self.seed)
        self._cam_cache: dict[int, dict] = {}
        # ground truth by (kf_id, pyramid level)
        self._gt_cache: dict[tuple[int, int], torch.Tensor] = {}
        # sensor-depth planes for lambda_depth (full resolution only; zeros
        # for a keyframe with no depth)
        self._depth_cache: dict[int, torch.Tensor] = {}
        self._eval_renderer: EvalRenderer | None = None
        self._pose_rows: dict[int, int] = {}  # kf_id -> pose-table row
        # pyramid level sizes: level i < num_sub_levels is w / 2^(num - i),
        # rounded down to a multiple of 16 (reference: graphics_utils.h:
        # 26-40); the last is full resolution
        n = self.num_pyramid_sub_levels
        self._level_sizes = [
            (max(16, self.width // 2 ** (n - i) // 16 * 16),
             max(16, self.height // 2 ** (n - i) // 16 * 16))
            for i in range(n)] + [(self.width, self.height)]

    def _build_step(self):
        """(Re)build the steps and densification from the configs: the
        schedules bake the spatial LR scale in."""
        self._steps: dict[tuple[int, int], callable] = {}
        self._adjust = make_adjust_anchor(self.model_config, self.opt_config)

    def _step_for(self, w: int, h: int):
        """The train step at image size (w, h), built at first use."""
        if (w, h) not in self._steps:
            self._steps[(w, h)] = make_train_step(
                self.model_config, self.opt_config, self.raster_config, w, h)
        return self._steps[(w, h)]

    # --- setup ---
    def add_keyframe(self, kf: Keyframe) -> None:
        kf.remaining_times_of_use = self.keyframe_times_of_use
        if self.num_pyramid_sub_levels and kf.gaus_pyramid_times_of_use \
                is None:
            kf.gaus_pyramid_times_of_use = [
                self.pyramid_times_of_use] * self.num_pyramid_sub_levels
        self.scene.add_keyframe(kf)
        self._cam_cache.pop(kf.kf_id, None)
        for lvl in range(self.num_pyramid_sub_levels + 1):
            self._gt_cache.pop((kf.kf_id, lvl), None)
        self._depth_cache.pop(kf.kf_id, None)
        if (self.optimize_poses and kf.kf_id not in self._pose_rows
                and len(self._pose_rows) < self.max_pose_kfs):
            self._pose_rows[kf.kf_id] = len(self._pose_rows)

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
        self.state = init_train_state(
            anchors, decoders.to(self.device), self.model_config,
            max_pose_kfs=self.max_pose_kfs if self.optimize_poses else 0)
        return n

    def insert_points(self, points: np.ndarray) -> int:
        with self.lock:
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
        with self.lock:
            self.state.anchors = dataclasses.replace(
                a, anchor=(a.anchor * scale) @ R.T + t,
                scaling=a.scaling + float(np.log(scale)), offset=new_offset,
                rotation=se3.normalize_quat(se3.quat_mul(q_r[None, :],
                                                         a.rotation)))

    # --- training ---
    def _kf_inputs(self, kf: Keyframe, level: int | None = None):
        """(cam, gt) of a keyframe: its render inputs on the device and its
        ground truth at pyramid `level` (default: full resolution), resized
        as jax.image.resize does."""
        if level is None:
            level = self.num_pyramid_sub_levels
        cam = self._cam_cache.get(kf.kf_id)
        if cam is None:
            cam = {k: torch.as_tensor(v, device=self.device)
                   for k, v in kf.render_inputs().items()}
            self._cam_cache[kf.kf_id] = cam
        gt = self._gt_cache.get((kf.kf_id, level))
        if gt is None:
            img = kf.image
            if img.shape[0] != 3:  # HWC -> CHW
                img = np.transpose(img, (2, 0, 1))
            gt = torch.as_tensor(np.asarray(img, np.float32),
                                 device=self.device)
            if level < self.num_pyramid_sub_levels:
                w, h = self._level_sizes[level]
                gt = losses.resize_bilinear(gt, h, w)
            self._gt_cache[(kf.kf_id, level)] = gt
        return cam, gt

    def _depth_of(self, kf: Keyframe) -> torch.Tensor:
        """The keyframe's sensor depth on the device (zeros without one)."""
        d = self._depth_cache.get(kf.kf_id)
        if d is None:
            d = torch.as_tensor(np.asarray(
                kf.depth if kf.depth is not None
                else np.zeros((self.height, self.width)), np.float32),
                device=self.device)
            self._depth_cache[kf.kf_id] = d
        return d

    # --- in-step pose optimisation bookkeeping ---
    @staticmethod
    def _fold_delta_np(q0, t0, delta):
        """Compose exp(delta) with a base (quat, trans) pose, as
        apply_pose_delta does on the device. Returns (quat, trans)."""
        delta = np.asarray(delta, np.float64)
        R0 = se3.quat_to_rotmat(torch.as_tensor(
            np.asarray(q0, np.float32))).numpy().astype(np.float64)
        R = _so3_exp_np(delta[:3])
        return (_quat_f32(R @ R0),
                R @ np.asarray(t0, np.float64) + delta[3:])

    def _reset_pose_rows(self, mask: torch.Tensor) -> None:
        """Zero the masked pose rows, their EMA and their moments."""
        optimizer.reset_rows(self.state.adam, lambda p: p[0] == "pose", mask)
        with torch.no_grad():
            self.state.pose.masked_fill_(mask[:, None], 0.0)
            self.state.pose_ema.masked_fill_(mask[:, None], 0.0)

    def set_keyframe_pose(self, kf: Keyframe, quat, trans) -> None:
        """Adopt an externally refreshed pose (SLAM BA, loop closure or
        scale refinement) and drop the keyframe's learned delta, which was
        relative to the stale base."""
        kf.set_pose(quat, trans)
        self._cam_cache.pop(kf.kf_id, None)
        row = self._pose_rows.get(kf.kf_id)
        if row is not None and self.state is not None \
                and self.state.pose_rows:
            self._reset_pose_rows(
                torch.arange(self.state.pose_rows, device=self.device)
                == row)

    def pose_delta_np(self, kf_id: int):
        """The keyframe's current learned SE3 delta, or None (no row, or a
        zero row). Reads the device."""
        row = self._pose_rows.get(kf_id)
        if row is None or self.state is None or not self.state.pose_rows:
            return None
        d = self.state.pose[row].cpu().numpy()
        return d if np.any(d) else None

    def refined_cam(self, kf: Keyframe) -> dict:
        """Render inputs at the pose-optimised camera (base composed with
        exp(delta))."""
        cam, _ = self._kf_inputs(kf)
        d = self.pose_delta_np(kf.kf_id)
        if d is None:
            return cam
        with torch.no_grad():
            return apply_pose_delta(cam, torch.as_tensor(d,
                                                         device=self.device))

    def fold_pose_deltas(self) -> int:
        """Fold every learned pose delta into its keyframe's base pose and
        clear the table and its moments. Call before exporting poses or a
        final evaluation, so that what reads the keyframes (PLY,
        cameras.json, trajectories, the recorder) sees the optimised poses.
        Returns the number of keyframes updated."""
        if self.state is None or not self.state.pose_rows:
            return 0
        table = self.state.pose.cpu().numpy()
        n = 0
        for kf_id, row in self._pose_rows.items():
            d = table[row]
            kf = self.scene.keyframes.get(kf_id)
            if not np.any(d) or kf is None:
                continue
            q, t = self._fold_delta_np(kf.quat, kf.trans, d)
            kf.set_pose(q, t)
            self._cam_cache.pop(kf_id, None)
            n += 1
        if n:
            self._reset_pose_rows(torch.ones(self.state.pose_rows,
                                             dtype=torch.bool,
                                             device=self.device))
        return n

    # --- photometric keyframe-pose refinement ---
    # A few steepest-descent steps on an SE3 tangent delta minimising the
    # photometric L1 against the keyframe image (and the sensor-depth
    # residual): absorbs tracker pose error. The JAX version jits the loop
    # as a fori_loop; here it is a Python loop whose values stay on the
    # device until the end.
    def _refine_loss(self, delta, cam, gt, gt_depth, use_depth: bool,
                     pool: int) -> torch.Tensor:
        st = self.state
        out = render(st.anchors, st.decoders, apply_pose_delta(cam, delta),
                     self.width, self.height, self._bg, self.model_config,
                     self.raster_config)
        mask = (gt != 0.0).any(dim=0, keepdim=True)
        loss = (_pool(out.image * mask, pool) - _pool(gt * mask, pool)).abs(
        ).mean()
        if use_depth:
            # sensor-depth residual (SplaTAM-style RGB-D alignment): it
            # constrains the view-axis translation the photometric term
            # barely sees. Alpha-normalised rendered depth over confident
            # (opacity > 0.5), valid-sensor pixels, in relative units
            opac = 1.0 - out.final_T
            dr = out.depth_map / torch.clamp(opac, min=1e-6)
            dm = ((gt_depth > 0.0) & (opac > 0.5)).float()
            dres = (dr - gt_depth).abs() * dm
            loss = loss + 0.2 * (dres / torch.clamp(gt_depth, min=0.1)).sum() \
                / torch.clamp(dm.sum(), min=1.0)
        return loss

    def _refine_delta(self, cam, gt, gt_depth, lr: float, steps: int,
                      use_depth: bool, pool: int):
        """(delta, loss before, loss after): normalised-gradient descent
        with three backtracking step lengths a step, keeping the best."""
        args = (cam, gt, gt_depth, use_depth, pool)
        d0 = torch.zeros(6, dtype=torch.float32, device=self.device)
        with torch.no_grad():
            l0 = self._refine_loss(d0, *args)
        delta, best = d0, l0
        for _ in range(steps):
            x = delta.detach().requires_grad_()
            with torch.enable_grad():
                (g,) = torch.autograd.grad(self._refine_loss(x, *args), x)
            with torch.no_grad():
                d = torch.cat([g[:3] / (torch.linalg.norm(g[:3]) + 1e-12),
                               g[3:] / (torch.linalg.norm(g[3:]) + 1e-12)])
                cands = torch.stack([delta - lr * d, delta - 0.3 * lr * d,
                                     delta - 0.1 * lr * d])
                ls = torch.stack([self._refine_loss(c, *args)
                                  for c in cands])
                j = torch.argmin(ls)
                better = ls[j] < best
                delta = torch.where(better, cands[j], delta)
                best = torch.where(better, ls[j], best)
        return torch.where(best < l0, delta, d0), l0, best

    def refine_keyframe_pose(self, kf: Keyframe, steps: int = 5,
                             lr: float = 4e-3, pool: int = 4) -> float:
        """Refine one keyframe's pose photometrically (plus the sensor-depth
        residual when the keyframe carries depth); updates the keyframe in
        place and returns the loss improvement (>= 0). pool=4 widens the
        photometric basin for online use; pool=1 is the full-resolution
        variant for shutdown refinement against a converged map."""
        cam, gt = self._kf_inputs(kf)
        use_depth = kf.depth is not None
        gt_depth = self._depth_of(kf)
        delta, l0, l1 = self._refine_delta(cam, gt, gt_depth, lr, steps,
                                           use_depth, pool)
        delta = delta.cpu().numpy().astype(np.float64)
        if not np.any(delta):
            return 0.0
        R = _so3_exp_np(delta[:3])
        kf.set_pose(_quat_f32(R @ kf.rotation_matrix()),
                    R @ np.asarray(kf.trans) + delta[3:])
        self._cam_cache.pop(kf.kf_id, None)
        return float(l0 - l1)

    def train_iteration(self):
        """One step on the next sliding-window keyframe, at its next pyramid
        level, with its pose row when poses are optimised (and
        densification when due). Returns the step's metrics, on the device,
        or None when the scene has no keyframe."""
        with tracing.span("train_step.inputs"):
            kf = self.scene.sample_sliding_window_keyframe()
            if kf is None:
                return None
            self.iteration += 1
            n = self.num_pyramid_sub_levels
            level = kf.next_pyramid_level(n) if n else n
            w, h = self._level_sizes[level]
            cam, gt = self._kf_inputs(kf, level)
            row = (self._pose_rows.get(kf.kf_id) if self.optimize_poses
                   else None)
            # the depth term at full resolution only
            gt_depth = (self._depth_of(kf)
                        if self.opt_config.lambda_depth > 0.0
                        and (w, h) == (self.width, self.height) else None)
            step = self._step_for(w, h)
        oc = self.opt_config
        it = self.iteration
        with self.lock:
            self.state, metrics = step(self.state, cam, gt, self._bg,
                                       kf_row=row, gt_depth=gt_depth)
            if oc.update_from < it < oc.update_until \
                    and it % oc.update_interval == 0:
                with tracing.span("train_step.densify"):
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
        if nc is not None and not self.raster_config.exact \
                and nc > self.raster_config.compact:
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
            cams = [self.refined_cam(kf)
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
        """The keyframe's (3, H, W) eval render at its refined pose."""
        return self.eval_renderer()(self.state.anchors, self.state.decoders,
                                    self.refined_cam(kf))

    def render_and_measure_keyframe(self, kf: Keyframe):
        """(masked image, psnr, ssim, psnr_gs) of the keyframe's eval
        render, as device tensors (no host sync). The mask keeps the pixels
        where the ground truth is not black."""
        with torch.no_grad():
            return losses.masked_image_metrics(self.render_keyframe(kf),
                                               self._kf_inputs(kf)[1])

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
