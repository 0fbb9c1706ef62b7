"""Run-artifact recorder: the reference's result-directory layout.

Port of segs_slam_tpu/eval/recorder.py:record_all_keyframes. It writes the
files the reference's mapper and examples write at shutdown, so that the
offline harness reads both systems alike (reference:
renderAndRecordKeyframe / renderAndRecordAllKeyframes,
src/gaussian_mapper.cpp:1769-1981, examples/tum_rgbd.cpp:239-263,677-693):

  <out>/rendered/<kfid>.png     <out>/ground_truth/<kfid>.png
  <out>/render_time.txt  (ms)   <out>/render_time_per_dispatch.txt (ms)
  <out>/psnr.txt                <out>/dssim.txt
  <out>/psnr_gaussian_splatting.txt
  <out>/RunningTime.txt         <out>/TrackingTime.txt
  <out>/gaussians_num.txt       <out>/keyframe_used_times.txt
  <out>/DevicePeakUsageMB.txt   (GpuPeakUsageMB.txt; CUDA devices only)

`record_all_frames` (every tracked frame at its estimated pose) waits for
the SLAM slice.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from segs_slam_tpu_torch.io.png import write_png

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
    cams = [trainer._kf_inputs(kf)[0] for _, kf in items]
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
