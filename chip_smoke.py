"""Smoke run of the PyTorch + CUDA port (segs_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device: a CUDA card must be present; prints the card's name and power
     limit and the torch / CUDA / nvcc versions;
  2. build: compiles kernel K1 (csrc/blend_fwd.cu) from this checkout;
  3. kernel: on a full-size 640x480 view of a seeded full-width map, K1
     against its plain PyTorch version on the same binned input (n_contrib
     equal on >= 99.99 % of pixels; there, colour and final_T within 2e-4
     and depth within rtol 1e-4), with CUDA-event timings and a per-layer
     breakdown of the render;
  4. main path: the same map rendered by the render_views app (8 orbit
     views at 480x480); images finite, in [0, 1] and not blank, and K1
     launched exactly once per view;
  5. small input: the whole render on the card against the CPU path (the
     plain version the CPU tests hold to the JAX package), image atol 2e-4.
Prints a JSON line with each kernel's numbers, then, as the last line,
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
SEED = 0
N_VIEWS = 8


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def seeded_map(mc, n_active: int, seed: int):
    """Anchors as bench.py places them (uniform in a 8 x 6 x 11.5 m box in
    front of the origin, offsets N(0, 0.3), features N(0, 0.1), scales 0.05)
    and decoders drawn from U(+-1/sqrt(fan_in)), as numpy arrays."""
    rng = np.random.default_rng(seed)
    cap, k, f = mc.capacity, mc.n_offsets, mc.feat_dim
    rot = np.zeros((cap, 4), np.float32)
    rot[:, 0] = 1.0
    active = np.zeros(cap, bool)
    active[:n_active] = True
    anchors = {
        "anchor": rng.uniform([-4, -3, 0.5], [4, 3, 12], (cap, 3)),
        "offset": rng.normal(0, 0.3, (cap, k, 3)),
        "feat": rng.normal(0, 0.1, (cap, f)),
        "scaling": np.full((cap, 6), np.log(0.05)),
        "rotation": rot,
        "opacity": np.full((cap, 1), np.log(0.1 / 0.9)),
        "active": active,
    }
    anchors = {n: v if v.dtype == bool else v.astype(np.float32)
               for n, v in anchors.items()}

    def linear(d_in, d_out):
        b = 1.0 / np.sqrt(d_in)
        return {"w": rng.uniform(-b, b, (d_in, d_out)).astype(np.float32),
                "b": rng.uniform(-b, b, (d_out,)).astype(np.float32)}

    decoders = {
        "opacity": {"l1": linear(mc.opacity_in, f), "l2": linear(f, k)},
        "cov": {"l1": linear(mc.cov_in, f), "l2": linear(f, 7 * k)},
        "color": {"l1": linear(mc.color_in, f), "l2": linear(f, 3 * k)},
        "appearance": linear(7, mc.appearance_dim),
        "embedding": {"table": rng.normal(
            size=(mc.embedding_dim, mc.appearance_dim)).astype(np.float32)},
    }
    return anchors, decoders


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of `reps` CUDA-event timings of fn(), after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_device():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    from segs_slam_tpu_torch.ops.cuda_lib import _nvcc

    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc {nvcc[-1] if nvcc else '?'} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # decoders in full f32
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from segs_slam_tpu_torch.ops.cuda_lib import build_library, load_library

    t0 = time.perf_counter()
    lib = build_library("blend_fwd")
    load_library("blend_fwd")
    print(f"[build] K1 blend_fwd in {time.perf_counter() - t0:.2f} s: "
          f"{lib.name}", flush=True)
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)


def phase_kernel(anchors, decoders, mc, rc, dev):
    from segs_slam_tpu_torch.core import Camera, Keyframe
    from segs_slam_tpu_torch.models.renderer import neural_gaussians_for_view
    from segs_slam_tpu_torch.ops.rasterizer import (
        compute_cov3d,
        preprocess_gaussians,
    )
    from segs_slam_tpu_torch.ops.rasterizer.binning import (
        compact_gaussians,
        expand_and_sort,
    )
    from segs_slam_tpu_torch.ops.rasterizer.blend import (
        blend_forward_cuda,
        blend_forward_reference,
    )
    from segs_slam_tpu_torch.ops.rasterizer.rasterize import blend_inputs

    w, h = 640, 480
    cam = Camera(camera_id=0, width=w, height=h, fx=500.0, fy=500.0,
                 cx=w / 2, cy=h / 2)
    kf = Keyframe(kf_id=0, camera=cam, quat=[1, 0, 0, 0], trans=[0, 0, 0])
    c = {k: torch.as_tensor(v, device=dev)
         for k, v in kf.render_inputs().items()}
    tx, ty = rc.grid(w, h)
    bg = torch.tensor([0.25, 0.5, 0.75], device=dev)

    stages = {}

    def decode():
        stages["decode"] = neural_gaussians_for_view(
            anchors, decoders, c, w, h, mc, rc)[1]

    def preprocess():
        ng = stages["decode"]
        proj = preprocess_gaussians(
            ng.xyz, compute_cov3d(ng.scaling, ng.rotation),
            c["world_view_transform"], c["full_proj_transform"], w, h,
            c["tan_fovx"], c["tan_fovy"], rc, valid_in=ng.valid)
        stages["preprocess"] = blend_inputs(proj, ng.opacity, ng.color)

    def compact():
        stages["compact"] = compact_gaussians(*stages["preprocess"], rc)

    def sort():
        stages["sort"] = expand_and_sort(stages["compact"], tx, ty, rc)

    with torch.inference_mode():
        layer_ms = {name: cuda_ms(fn, reps=10) for name, fn in (
            ("decode", decode), ("preprocess", preprocess),
            ("compact", compact), ("expand_sort", sort))}
        b = stages["sort"]
        args = (b.feats_sorted, b.tile_start, b.tile_stop, bg, tx, rc)
        ref = blend_forward_reference(*args)
        got = blend_forward_cuda(*args)
        torch.cuda.synchronize()
        kernel_ms = cuda_ms(lambda: blend_forward_cuda(*args), reps=20,
                            warmup=3)
        plain_ms = cuda_ms(lambda: blend_forward_reference(*args), reps=10)
    layer_ms["blend_K1"] = kernel_ms

    nc_eq = got[3] == ref[3]
    agree = float(nc_eq.float().mean())
    err = {name: float((g - r).abs().max()) for name, g, r in
           zip(("color", "final_T", "depth"), got[:3], ref[:3])}
    ok_c = ((got[0] - ref[0]).abs() <= 2e-4)[nc_eq.expand_as(ref[0])].all()
    ok_t = ((got[1] - ref[1]).abs() <= 2e-4)[nc_eq].all()
    ok_d = ((got[2] - ref[2]).abs() <= 1e-4 * ref[2].abs())[nc_eq].all()
    n_inst = int(b.num_instances)
    print(f"[kernel] 640x480, {tx * ty} tiles, NK {b.feats_sorted.shape[1]}, "
          f"{n_inst} instances, num_compact {int(stages['compact'].num_valid)}"
          f" of {rc.compact}; n_contrib equal on {agree * 100:.4f} % of "
          f"pixels; max |err| {err}", flush=True)
    print(f"[kernel] K1 {kernel_ms:.4f} ms, plain {plain_ms:.3f} ms "
          f"(CUDA events, median)", flush=True)
    print(f"[kernel] layers (ms, CUDA events, median of 10): "
          f"{json.dumps({k: round(v, 4) for k, v in layer_ms.items()})}",
          flush=True)
    if not (torch.isfinite(got[0]).all() and torch.isfinite(got[2]).all()):
        fail("K1 output is not finite")
    if agree < 0.9999:
        fail(f"n_contrib equal on only {agree * 100:.4f} % of pixels")
    if not (ok_c and ok_t and ok_d):
        fail(f"K1 disagrees with its plain version: {err}")
    if n_inst == 0:
        fail("the kernel-phase view binned no instances")
    return {"max_abs_err": max(err["color"], err["final_T"]),
            "ms": kernel_ms, "plain_ms": plain_ms}


def phase_main_path(map_path, rc):
    from segs_slam_tpu_torch.apps import render_views
    from segs_slam_tpu_torch.ops.rasterizer.blend import blend_forward_cuda

    out_dir = WORK / "views"
    argv = ["--map", str(map_path), "--out", str(out_dir), "--size", "480",
            "--orbit-frames", str(N_VIEWS), "--compact", str(rc.compact),
            "--kmax", str(rc.kmax), "--ksmall", str(rc.ksmall),
            "--nlarge", str(rc.nlarge), "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blend_forward_cuda.launches = 0
    views = render_views.main(argv)
    launches = blend_forward_cuda.launches
    peak = torch.cuda.max_memory_allocated()

    if len(views) != N_VIEWS:
        fail(f"render_views returned {len(views)} views, not {N_VIEWS}")
    for i, v in enumerate(views):
        img = v["image"]
        if img.shape != (3, 480, 480) or not np.isfinite(img).all():
            fail(f"view {i}: shape {img.shape} or non-finite values")
        if img.min() < 0.0 or img.max() > 1.0 + 1e-6:
            fail(f"view {i} outside [0, 1]: {img.min()} .. {img.max()}")
        if img.max() - img.min() < 0.05:
            fail(f"view {i} is blank (range {img.max() - img.min()})")
        if not (out_dir / f"view{i:04d}.png").is_file():
            fail(f"view {i} PNG missing")
    if launches != N_VIEWS:
        fail(f"K1 launched {launches} times for {N_VIEWS} views")
    ms = [v["ms"] for v in views]
    print(f"[main] render_views: {N_VIEWS} views at 480x480, ms/view "
          f"{json.dumps([round(x, 3) for x in ms])}; mean {np.mean(ms):.3f} "
          f"ms, mean without the first {np.mean(ms[1:]):.3f} ms "
          f"({1000 / np.mean(ms[1:]):.1f} FPS); peak memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    print(f"[main] num_compact {[v['num_compact'] for v in views]} of "
          f"{rc.compact}; num_instances "
          f"{[v['num_instances'] for v in views]} of {rc.max_instances}",
          flush=True)
    return launches


def phase_small_input(dev):
    """The whole render of a small map on the card against the CPU path."""
    from segs_slam_tpu_torch.core import Camera, Keyframe
    from segs_slam_tpu_torch.io.convert import (
        anchors_from_numpy,
        decoders_from_jax,
        flatten_params,
    )
    from segs_slam_tpu_torch.models.config import ModelConfig
    from segs_slam_tpu_torch.models.renderer import render
    from segs_slam_tpu_torch.ops.rasterizer import RasterConfig

    mc = ModelConfig(capacity=256, feat_dim=8, n_offsets=4, appearance_dim=8)
    anchors_np, dec_np = seeded_map(mc, 200, SEED + 1)
    rc = RasterConfig(tile=16, compact=2048, kmax=8, chunk=256, ksmall=4,
                      nlarge=256)
    w, h = 96, 64
    cam = Camera(camera_id=0, width=w, height=h, fx=80.0, fy=80.0,
                 cx=w / 2, cy=h / 2)
    kf = Keyframe(kf_id=0, camera=cam, quat=[1, 0, 0, 0], trans=[0, 0, 0])
    outs = []
    for d in ("cpu", dev):
        with torch.inference_mode():
            outs.append(render(
                anchors_from_numpy(anchors_np, d),
                decoders_from_jax(flatten_params(dec_np), d),
                {k: torch.as_tensor(v, device=d)
                 for k, v in kf.render_inputs().items()},
                w, h, torch.tensor([0.1, 0.2, 0.3], device=d), mc, rc))
    cpu, gpu = outs
    err = float((gpu.image.cpu() - cpu.image).abs().max())
    print(f"[small] 96x64 render, card vs CPU path: max |image err| {err:.3g}"
          f", num_compact {int(gpu.num_compact)}/{int(cpu.num_compact)}, "
          f"num_instances {int(gpu.num_instances)}/{int(cpu.num_instances)}",
          flush=True)
    if err > 2e-4 or int(gpu.num_compact) != int(cpu.num_compact) \
            or int(gpu.num_instances) != int(cpu.num_instances):
        fail("the card's render disagrees with the CPU path")
    if float(cpu.image.max() - cpu.image.min()) < 0.05:
        fail("the small-input render is blank")


def main():
    t_start = time.perf_counter()
    phase_device()
    from segs_slam_tpu_torch.io.convert import load_map, save_map
    from segs_slam_tpu_torch.models.config import ModelConfig
    from segs_slam_tpu_torch.ops.rasterizer import RasterConfig

    dev = torch.device("cuda")
    phase_build()

    WORK.mkdir(parents=True, exist_ok=True)
    mc = ModelConfig()
    anchors_np, dec_np = seeded_map(mc, n_active=2**15, seed=SEED)
    map_path = WORK / "map.npz"
    save_map(map_path, anchors_np, dec_np)
    # the app's raster defaults (segs_slam_tpu/apps/common.py:36-49)
    rc = RasterConfig(tile=16, compact=2**16, kmax=8, chunk=256, ksmall=4,
                      nlarge=2**13)
    anchors, decoders = load_map(map_path, dev)
    kernel = phase_kernel(anchors, decoders, mc, rc, dev)
    launches = phase_main_path(map_path, rc)
    phase_small_input(dev)

    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [{
        "name": "blend_fwd", "route": "cuda",
        "source": "segs_slam_tpu_torch/csrc/blend_fwd.cu",
        "replaces": "segs_slam_tpu/ops/rasterizer/blend.py:361",
        "launches": launches, **kernel}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
