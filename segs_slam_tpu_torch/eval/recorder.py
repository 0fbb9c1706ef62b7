"""Run-artifact recorder: the reference's result-directory layout.

Port of segs_slam_tpu/eval/recorder.py. It writes the files the
reference's mapper and examples write at shutdown, so that the offline
harness reads both systems alike (reference:
renderAndRecordKeyframe / renderAndRecordAllKeyframes,
src/gaussian_mapper.cpp:1769-1981, examples/tum_rgbd.cpp:239-263,677-693):

  <out>/rendered/<kfid>.png     <out>/ground_truth/<kfid>.png
  <out>/render_time.txt  (ms)   <out>/render_time_per_dispatch.txt (ms)
  <out>/psnr.txt                <out>/dssim.txt
  <out>/psnr_gaussian_splatting.txt
  <out>/RunningTime.txt         <out>/TrackingTime.txt
  <out>/gaussians_num.txt       <out>/keyframe_used_times.txt
  <out>/DevicePeakUsageMB.txt   (GpuPeakUsageMB.txt; CUDA devices only)

`record_all_frames` renders every tracked frame at its estimated pose
(reference: renderAndRecordAllframes, src/gaussian_mapper.cpp:1983-2125)
into `<out>/<iteration>_images/`.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from segs_slam_tpu_torch.io.png import write_png
from segs_slam_tpu_torch.train.losses import masked_image_metrics

RENDER_BATCH = 10  # frames per render_batch call in the headline timing


def _save_png(path: Path, img_chw: np.ndarray) -> None:
    arr = np.clip(np.asarray(img_chw), 0, 1)
    write_png(path, (np.transpose(arr, (1, 2, 0)) * 255).astype(np.uint8))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_render_ms(trainer, renderer, cams) -> tuple[float, float]:
    """Per-frame render time over cameras already on the device, measured
    as the JAX recorder measures it, both ways: (batched_ms,
    per_dispatch_ms). batched: render_batch over stacks of RENDER_BATCH
    cameras (the tail stack padded with the last camera), one sync per
    stack; per dispatch: one render call per frame, back to back, one sync
    over the run. A host clock around renders that end in a device sync;
    one render before each measurement warms the caches. (The JAX recorder
    batches to spread the TPU's dispatch cost; render_batch is a loop here,
    so the two measure the same renders with different sync points.)"""
    anchors, decoders = trainer.state.anchors, trainer.state.decoders
    dev = trainer.device

    def per_dispatch():
        renderer(anchors, decoders, cams[0])
        _sync(dev)
        t0 = time.perf_counter()
        for c in cams:
            renderer(anchors, decoders, c)
        _sync(dev)
        return (time.perf_counter() - t0) * 1000.0 / len(cams)

    if len(cams) < 2:
        ms = per_dispatch()
        return ms, ms
    bsz = min(RENDER_BATCH, len(cams))
    padded = cams + [cams[-1]] * ((-len(cams)) % bsz)
    stacks = [{k: torch.stack([c[k] for c in padded[b0:b0 + bsz]])
               for k in cams[0]} for b0 in range(0, len(padded), bsz)]
    renderer.render_batch(anchors, decoders, stacks[0])  # warm
    _sync(dev)
    t0 = time.perf_counter()
    for s in stacks:
        renderer.render_batch(anchors, decoders, s)
        _sync(dev)
    batched_ms = (time.perf_counter() - t0) * 1000.0 / len(padded)
    return batched_ms, per_dispatch()


def record_all_keyframes(trainer, out_dir: str | Path,
                         record_images: bool = True,
                         tracking_times: list | None = None,
                         total_runtime_s: float | None = None) -> dict:
    """Render every keyframe through the Trainer's EvalRenderer and write
    the metric and timing artifacts; returns the aggregate metrics (psnr,
    dssim, psnr_gs, and render_fps = 1000 / mean render ms, the reference's
    eval/run.py:156-158)."""
    out = Path(out_dir)
    (out / "rendered").mkdir(parents=True, exist_ok=True)
    (out / "ground_truth").mkdir(parents=True, exist_ok=True)
    items = sorted(trainer.scene.keyframes.items())

    # The clock covers the renders alone, as the reference's
    # render_time.txt does (src/gaussian_mapper.cpp:1782-1808): the cameras
    # are staged on the device first, and the ground truth and the metrics
    # stay outside it.
    renderer = trainer.eval_renderer()
    cams = [trainer.refined_cam(kf) for _, kf in items]
    if cams:
        per_frame_ms, per_dispatch_ms = _timed_render_ms(trainer, renderer,
                                                         cams)
    else:
        per_frame_ms = per_dispatch_ms = 0.0

    # metrics pass, untimed
    outputs = [trainer.render_and_measure_keyframe(kf) for _, kf in items]
    render_ms, psnrs, dssims, psnr_gs = [], [], [], []
    for (kid, kf), (img_m, p, s, pg) in zip(items, outputs):
        render_ms.append(per_frame_ms)
        psnrs.append(float(p))
        dssims.append(1.0 - float(s))
        psnr_gs.append(float(pg))
        if record_images:
            gt = trainer._kf_inputs(kf)[1].cpu().numpy()
            mask = np.any(gt != 0.0, axis=0, keepdims=True)
            _save_png(out / "rendered" / f"{kid:06d}.png",
                      img_m.cpu().numpy())
            _save_png(out / "ground_truth" / f"{kid:06d}.png", gt * mask)

    def dump(name, vals, fmt="{:.6f}"):
        with open(out / name, "w") as f:
            for v in vals:
                f.write(fmt.format(v) + "\n")

    dump("render_time.txt", render_ms)
    dump("render_time_per_dispatch.txt", [per_dispatch_ms] * len(items))
    dump("psnr.txt", psnrs)
    dump("dssim.txt", dssims)
    dump("psnr_gaussian_splatting.txt", psnr_gs)
    dump("gaussians_num.txt", [int(trainer.state.anchors.num_active())], "{}")
    with open(out / "keyframe_used_times.txt", "w") as f:
        for kid, n in sorted(trainer.scene.kfs_used_times.items()):
            f.write(f"{kid} {n}\n")
    if tracking_times:
        dump("TrackingTime.txt", tracking_times)
    if total_runtime_s is not None:
        dump("RunningTime.txt", [total_runtime_s])
    if trainer.device.type == "cuda":
        dump("DevicePeakUsageMB.txt",
             [torch.cuda.max_memory_allocated(trainer.device) / 1e6])

    return {
        "psnr": float(np.mean(psnrs)) if psnrs else 0.0,
        "dssim": float(np.mean(dssims)) if dssims else 0.0,
        "psnr_gs": float(np.mean(psnr_gs)) if psnr_gs else 0.0,
        "render_fps": 1000.0 / np.mean(render_ms) if render_ms else 0.0,
    }


def record_all_frames(trainer, out_dir: str | Path, frames, est_poses,
                      camera, record_images: bool = False,
                      image_stride: int = 20, batch: int = 16) -> dict:
    """Novel-view evaluation over every tracked frame, not just keyframes
    (reference: renderAndRecordAllframes, src/gaussian_mapper.cpp:1983-2125,
    driven post-run by examples/tum_rgbd.cpp:272-620). Renders each frame at
    its estimated pose through the Trainer's EvalRenderer (kernel K3 on a
    card) against the dataset's image, and writes the reference's
    `<iteration>_images/` layout:

      <out>/<iter>_images/all_image/  all_image_gt/  (pngs, strided)
      <out>/<iter>_images/dssim.txt  psnr_gaussian_splatting.txt  psnr.txt
      <out>/<iter>_images/render_time.txt  AllCameraTrajectory_TUM.txt

    `frames` are dataset frame records (load_rgb()); `est_poses` is a list of
    (quat, trans) world-to-camera estimates, one per frame (None entries are
    skipped). Frames go in batches of `batch`: their cameras and images are
    staged on the device first, then the batch's renders are timed (a host
    clock around renders that end in a device sync), then measured."""
    from segs_slam_tpu_torch.core.keyframe import Keyframe

    out = Path(out_dir) / f"{trainer.iteration}_images"
    img_dir = out / "all_image"
    gt_dir = out / "all_image_gt"
    out.mkdir(parents=True, exist_ok=True)
    if record_images:
        img_dir.mkdir(exist_ok=True)
        gt_dir.mkdir(exist_ok=True)
    renderer = trainer.eval_renderer()
    anchors, decoders = trainer.state.anchors, trainer.state.decoders
    dev = trainer.device

    def _inputs(fr, pose):
        quat, trans = pose
        kf = Keyframe(kf_id=0, camera=camera, quat=quat, trans=trans)
        cam = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
               for k, v in kf.render_inputs().items()}
        img = fr.load_rgb()
        if img.shape[0] != 3:
            img = np.transpose(img, (2, 0, 1))
        return cam, torch.as_tensor(np.asarray(img, np.float32), device=dev)

    idxs = [i for i, p in enumerate(est_poses[: len(frames)])
            if p is not None]
    psnrs, dssims, psnr_gs, render_ms, rows = [], [], [], [], []
    if idxs:  # one render before the clock warms the caches
        renderer(anchors, decoders, _inputs(frames[idxs[0]],
                                            est_poses[idxs[0]])[0])
    for b0 in range(0, len(idxs), batch):
        chunk = idxs[b0:b0 + batch]
        inputs = [_inputs(frames[i], est_poses[i]) for i in chunk]
        _sync(dev)
        t0 = time.perf_counter()
        imgs = [renderer(anchors, decoders, cam) for cam, _ in inputs]
        _sync(dev)
        per_ms = (time.perf_counter() - t0) * 1000.0 / len(chunk)
        with torch.no_grad():
            outs = [masked_image_metrics(img, gt)
                    for img, (_, gt) in zip(imgs, inputs)]
        for i, (_, gt), (img_m, p, s, pg) in zip(chunk, inputs, outs):
            psnrs.append(float(p))
            dssims.append(1.0 - float(s))
            psnr_gs.append(float(pg))
            render_ms.append(per_ms)
            rows.append(i)
            if record_images and i % image_stride == 0:
                gt_np = gt.cpu().numpy()
                mask = np.any(gt_np != 0.0, axis=0, keepdims=True)
                _save_png(img_dir / f"{i:06d}.png", img_m.cpu().numpy())
                _save_png(gt_dir / f"{i:06d}.png", gt_np * mask)

    def dump(name, vals, fmt="{} {:.10f}"):
        with open(out / name, "w") as f:
            for i, v in zip(rows, vals):
                f.write(fmt.format(i, v) + "\n")

    dump("psnr.txt", psnrs)
    dump("dssim.txt", dssims)
    dump("psnr_gaussian_splatting.txt", psnr_gs)
    dump("render_time.txt", render_ms)
    with open(out / "AllCameraTrajectory_TUM.txt", "w") as f:
        for i in rows:
            quat, trans = est_poses[i]
            w_, x_, y_, z_ = np.asarray(quat, np.float64)
            R = np.array([
                [1 - 2 * (y_ * y_ + z_ * z_), 2 * (x_ * y_ - w_ * z_),
                 2 * (x_ * z_ + w_ * y_)],
                [2 * (x_ * y_ + w_ * z_), 1 - 2 * (x_ * x_ + z_ * z_),
                 2 * (y_ * z_ - w_ * x_)],
                [2 * (x_ * z_ - w_ * y_), 2 * (y_ * z_ + w_ * x_),
                 1 - 2 * (x_ * x_ + y_ * y_)],
            ])
            c = -R.T @ np.asarray(trans, np.float64)
            f.write(f"{frames[i].timestamp:.6f} {c[0]:.9f} {c[1]:.9f} "
                    f"{c[2]:.9f} {x_:.9f} {y_:.9f} {z_:.9f} {w_:.9f}\n")

    return {
        "psnr": float(np.mean(psnrs)) if psnrs else 0.0,
        "dssim": float(np.mean(dssims)) if dssims else 0.0,
        "psnr_gs": float(np.mean(psnr_gs)) if psnr_gs else 0.0,
        "render_fps": 1000.0 / np.mean(render_ms) if render_ms else 0.0,
        "n_frames": len(rows),
    }
