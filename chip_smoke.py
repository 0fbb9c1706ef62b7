"""Smoke run of the PyTorch + CUDA port (segs_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device: a CUDA card must be present; prints the card's name and power
     limit and the torch / CUDA / nvcc versions;
  2. build: compiles kernels K1 (csrc/blend_fwd.cu) and K2
     (csrc/blend_bwd.cu) from this checkout, one nvcc each, in parallel;
     prints ptxas registers and spills;
  3. kernels: on a full-size 640x480 view of a seeded full-width map, K1
     against its plain PyTorch version on the same binned input (n_contrib
     equal on >= 99.99 % of pixels; there, colour and final_T within 2e-4
     and depth within rtol 1e-4), then K2 against its plain version on the
     same input with seeded colour / depth / final_T cotangents (every
     gradient row within 1e-4 of that row's largest magnitude); CUDA-event
     timings, bounds, and a per-layer breakdown of the render;
  4. render path: the map rendered by the render_views app (8 orbit views
     at 480x480); images finite, in [0, 1] and not blank, K1 launched once
     per view;
  5. training path: the train_synthetic app at its full width for 300
     iterations with the frequency losses; the loss finite throughout and
     lower at the end than at the start, the evaluate PSNR at least 3 dB
     above the untrained map's, K2 launched once per iteration;
  6. trained map: a second Trainer built with the same flags. Inside the
     frequency-loss window, the step's layers (forward, loss, backward,
     Adam: make_train_step's record_function ranges) and the device's busy
     share by torch.profiler. After 300 iterations, K1 and K2 against their
     plain versions, at the gates of phase 3, on the inputs of 24 further
     steps: with the loss's own cotangents, with seeded ones, and with the
     opacities above 0.5 raised to 1 so that alpha meets the 0.99 clamp;
     the kernels' times and bounds on those inputs go into the kernels
     line;
  7. densify: a Trainer at the same width whose densification runs four
     times in 55 iterations; active slots contiguous, parameters finite,
     n_active changed, the loss after it finite; one adjust timed;
  8. small input: the whole render, and one train step, of a small map on
     the card against the CPU path (the plain versions the CPU tests hold
     to the JAX package): image atol 2e-4, per-leaf gradients within 2e-4
     of the leaf's largest, loss within rtol 1e-5.
Prints a JSON line with each kernel's numbers, then, as the last line,
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
SEED = 0
N_VIEWS = 8
TRAIN_ITERS = 300
KERNELS = ("blend_fwd", "blend_bwd")

TRAINED_STEPS = 24
LAYERS = ("forward", "loss", "backward", "adam")

# For the bounds: H100 SXM HBM3 rate and FP32 peak outside the tensor cores
# (NVIDIA's data sheet, 700 W), and the FP32 operations per (pixel,
# instance) pair, counted from the sources with a multiply-add as two and
# expf or a division as one. Every pair a kernel must test costs the offset
# (2), the EWA exponent (9) and the power test (1). A pair the pixel takes
# (it passed the skips and lies below its n_contrib) costs besides: in K1,
# exp, op G, the clamp, the alpha test, T (1 - alpha), the latch test, w
# and four weighted sums (16); in K2, exp, op G, the clamp, the alpha test,
# 1 - alpha, T recovery, w, g (7), dpower (4), S (2), the ten gradient
# values (20) and their sums over the tile's pixels (10) (50).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_TEST = 12
K1_OPS_PER_TAKE = 16
K2_OPS_PER_TAKE = 50


def fail(msg: str):
    # on both streams: a caller that keeps only the end of one still sees it
    print(f"chip_smoke FAILED: {msg}", flush=True)
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
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


def bound(work: tuple[float, float], calls: int = 1) -> dict:
    """The least time the card could take for one of `calls` calls that
    together move work = (bytes, FP32 operations): the larger of the bytes
    over the memory rate and the operations over the FP32 peak."""
    t_bytes = work[0] / HBM_BYTES_PER_S * 1e3 / calls
    t_ops = work[1] / FP32_OPS_PER_S * 1e3 / calls
    return {"bound_ms": float(max(t_bytes, t_ops)),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def pair_counts(feats, tile_start, tile_stop, ncontrib, tiles_x, rc) -> dict:
    """The (pixel, instance) pairs of one binned view, from the plain
    version's per-pair alphas and K1's n_contrib: `taken` (the pixel takes
    the instance), `clamped` (taken, with op G above the 0.99 clamp),
    `fwd_tested` (what K1 must test: every instance of the tile up to the
    one at which the pixel latches, or all of them) and `bwd_tested` (what
    K2 must test: the instances below the pixel's n_contrib)."""
    from segs_slam_tpu_torch.ops.rasterizer.blend import (
        _group_alpha,
        _tile_groups,
    )

    counts = (tile_stop - tile_start).tolist()
    n = dict.fromkeys(("fwd_tested", "bwd_tested", "taken", "clamped"), 0)
    for t0, t1, length in _tile_groups(counts, rc.tile * rc.tile):
        _, inside, _, _, _, opg, alpha = _group_alpha(
            feats, tile_start, counts, t0, t1, length, tiles_x, rc)
        below = (torch.arange(length, device=feats.device)
                 < ncontrib[t0:t1, 0, :, None])
        taken = below & (alpha > 0.0)
        cum = torch.cumprod(1.0 - alpha, dim=-1)
        t_before = torch.cat([torch.ones_like(cum[..., :1]), cum[..., :-1]],
                             -1)
        n["fwd_tested"] += int((inside[:, None, :]
                                & (t_before >= rc.transmittance_min)).sum())
        n["bwd_tested"] += int(below.sum())
        n["taken"] += int(taken.sum())
        n["clamped"] += int((taken & (opg > rc.alpha_clamp)).sum())
    return n


def blend_work(tile_start, tile_stop, ncontrib, nk, pairs):
    """K1's and K2's (bytes, FP32 operations) on one binned view. K1 reads
    each instance of a tile range once (40 B), the tile ranges and bg, and
    writes 24 B a pixel; K2 reads the instances up to its tile's largest
    n_contrib, 28 B of cotangents and forward outputs a pixel, and writes
    the [10, NK] gradient array once."""
    nt, npix = ncontrib.shape[0], ncontrib.shape[2]
    counts = (tile_stop - tile_start).long()
    walked = float(torch.minimum(ncontrib.reshape(nt, -1).amax(dim=1).long(),
                                 counts).sum())
    k1 = (int(counts.sum()) * 40 + nt * 8 + 12 + nt * npix * 24,
          OPS_PER_TEST * pairs["fwd_tested"]
          + K1_OPS_PER_TAKE * pairs["taken"])
    k2 = (walked * 40 + nt * npix * 28 + nt * 8 + 12 + 40 * nk,
          OPS_PER_TEST * pairs["bwd_tested"]
          + K2_OPS_PER_TAKE * pairs["taken"])
    return k1, k2


def check_forward(args) -> dict:
    """K1 against its plain version on one binned input (feats, tile_start,
    tile_stop, bg, tiles_x, config): n_contrib compared exactly; where it
    is equal, colour and final_T within 2e-4 and depth within rtol 1e-4."""
    from segs_slam_tpu_torch.ops.rasterizer.blend import (
        blend_forward_cuda,
        blend_forward_reference,
    )

    ref = blend_forward_reference(*args)
    got = blend_forward_cuda(*args)
    nc_eq = got[3] == ref[3]
    err = {name: float((g - r).abs().max()) for name, g, r in
           zip(("color", "final_T", "depth"), got[:3], ref[:3])}
    ok = bool(((got[0] - ref[0]).abs() <= 2e-4)[nc_eq.expand_as(ref[0])].all()
              and ((got[1] - ref[1]).abs() <= 2e-4)[nc_eq].all()
              and ((got[2] - ref[2]).abs() <= 1e-4 * ref[2].abs())[
                  nc_eq].all()
              and torch.isfinite(got[0]).all()
              and torch.isfinite(got[2]).all())
    return {"out": got, "equal": int(nc_eq.sum()), "pixels": nc_eq.numel(),
            "err": err, "ok": ok}


def check_backward(args) -> dict:
    """K2 against its plain version on one binned input with its cotangents
    and K1's final_T and n_contrib: each gradient row's largest error over
    the row's largest magnitude (a row that is zero in the plain version
    must be zero in K2's)."""
    from segs_slam_tpu_torch.ops.rasterizer.blend import (
        blend_backward_cuda,
        blend_backward_reference,
    )

    ref = blend_backward_reference(*args)
    got = blend_backward_cuda(*args)
    diff = (got - ref).abs().amax(dim=1)
    scale = ref.abs().amax(dim=1)
    row_err = torch.where(scale > 0, diff / scale.clamp(min=1e-30),
                          torch.where(diff > 0, float("inf"), 0.0))
    return {"row_err": row_err.tolist(), "max_abs_err": float(diff.max()),
            "zero_rows": int((scale == 0).sum()),
            "ok": bool(torch.isfinite(got).all()) and float(row_err.max())
            <= 1e-4}


def launch_counters():
    from segs_slam_tpu_torch.ops.rasterizer.blend import (
        blend_backward_cuda,
        blend_forward_cuda,
    )

    return {"blend_fwd": blend_forward_cuda, "blend_bwd": blend_backward_cuda}


def reset_launches():
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


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
    torch.backends.cuda.matmul.allow_tf32 = False  # decoders, SSIM in f32
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from segs_slam_tpu_torch.ops.cuda_lib import build_library, load_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as ex:
        libs = dict(zip(KERNELS, ex.map(build_library, KERNELS)))
    for name, lib in libs.items():
        load_library(name)
        print(f"[build] {name}: {lib.name}", flush=True)
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}", flush=True)
    print(f"[build] K1 + K2 in {time.perf_counter() - t0:.2f} s", flush=True)


def phase_kernels(anchors, decoders, mc, rc, dev):
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
        blend_backward_cuda,
        blend_backward_reference,
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
    nt = tx * ty
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
        fwd = check_forward(args)
        torch.cuda.synchronize()
        k1_ms = cuda_ms(lambda: blend_forward_cuda(*args), reps=20,
                        warmup=3)
        k1_plain_ms = cuda_ms(lambda: blend_forward_reference(*args),
                              reps=10)
    layer_ms["blend_K1"] = k1_ms

    agree = fwd["equal"] / fwd["pixels"]
    n_inst = int((b.tile_stop - b.tile_start).sum())
    print(f"[kernel] 640x480, {nt} tiles, NK {b.feats_sorted.shape[1]}, "
          f"{n_inst} instances, num_compact {int(stages['compact'].num_valid)}"
          f" of {rc.compact}; n_contrib equal on {agree * 100:.4f} % of "
          f"pixels; max |err| {fwd['err']}", flush=True)
    print(f"[kernel] K1 {k1_ms:.4f} ms, plain {k1_plain_ms:.3f} ms "
          f"(CUDA events, median)", flush=True)
    print(f"[kernel] layers (ms, CUDA events, median of 10): "
          f"{json.dumps({k: round(v, 4) for k, v in layer_ms.items()})}",
          flush=True)
    if agree < 0.9999:
        fail(f"n_contrib equal on only {agree * 100:.4f} % of pixels")
    if not fwd["ok"]:
        fail(f"K1 disagrees with its plain version: {fwd['err']}")
    if n_inst == 0:
        fail("the kernel-phase view binned no instances")

    # K2 on the same binned input and K1's outputs, with seeded cotangents.
    got = fwd["out"]
    g = torch.Generator().manual_seed(SEED + 2)
    dcolor = torch.randn(nt, 3, 256, generator=g).to(dev)
    ddepth = (0.1 * torch.randn(nt, 1, 256, generator=g)).to(dev)
    dfinal_t = torch.randn(nt, 1, 256, generator=g).to(dev)
    bargs = (*args, dcolor, ddepth, dfinal_t, got[1], got[3])
    with torch.inference_mode():
        bwd = check_backward(bargs)
        torch.cuda.synchronize()
        k2_ms = cuda_ms(lambda: blend_backward_cuda(*bargs), reps=20,
                        warmup=3)
        k2_plain_ms = cuda_ms(lambda: blend_backward_reference(*bargs),
                              reps=5)
        pairs = pair_counts(*args[:3], got[3], tx, rc)
    print(f"[kernel] K2 {k2_ms:.4f} ms, plain {k2_plain_ms:.3f} ms (CUDA "
          f"events, median); per-row max |err| / row max: "
          f"{[f'{e:.2e}' for e in bwd['row_err']]}", flush=True)
    if bwd["zero_rows"]:
        fail("a K2 gradient row is all zeros on the kernel-phase view")
    if not bwd["ok"]:
        fail(f"K2 disagrees with its plain version: {bwd['row_err']}")
    k1_bound, k2_bound = map(bound, blend_work(
        b.tile_start, b.tile_stop, got[3], b.feats_sorted.shape[1], pairs))
    print(f"[kernel] bounds: K1 {k1_bound['bound_ms']:.4f} ms "
          f"({k1_bound['bound_by']}), K2 {k2_bound['bound_ms']:.4f} ms "
          f"({k2_bound['bound_by']}); (pixel, instance) pairs {pairs}",
          flush=True)


def phase_render_path(map_path, rc):
    from segs_slam_tpu_torch.apps import render_views

    out_dir = WORK / "views"
    argv = ["--map", str(map_path), "--out", str(out_dir), "--size", "480",
            "--orbit-frames", str(N_VIEWS), "--compact", str(rc.compact),
            "--kmax", str(rc.kmax), "--ksmall", str(rc.ksmall),
            "--nlarge", str(rc.nlarge), "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    views = render_views.main(argv)
    launches = read_launches()
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
    if launches != {"blend_fwd": N_VIEWS, "blend_bwd": 0}:
        fail(f"launches {launches} for {N_VIEWS} views")
    ms = [v["ms"] for v in views]
    print(f"[render] render_views: {N_VIEWS} views at 480x480, ms/view "
          f"{json.dumps([round(x, 3) for x in ms])}; mean {np.mean(ms):.3f} "
          f"ms, mean without the first {np.mean(ms[1:]):.3f} ms "
          f"({1000 / np.mean(ms[1:]):.1f} FPS); peak memory "
          f"{peak / 2**20:.1f} MiB; launches {launches}", flush=True)
    print(f"[render] num_compact {[v['num_compact'] for v in views]} of "
          f"{rc.compact}; num_instances "
          f"{[v['num_instances'] for v in views]} of {rc.max_instances}",
          flush=True)


def phase_train_path():
    from segs_slam_tpu_torch.apps import train_synthetic

    argv = ["--iters", str(TRAIN_ITERS), "--freq-reg", "--log-every", "100",
            "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    m = train_synthetic.main(argv)
    launches = read_launches()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    losses = np.asarray(m["losses"])
    n_views = m["n_keyframes"]
    print(f"[train] train_synthetic {TRAIN_ITERS} iters at 256x256, "
          f"{n_views} views: {m['ms_per_iter']:.3f} ms/iter; loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; PSNR {m['psnr_init']:.3f} "
          f"-> {m['psnr']:.3f} dB, SSIM {m['ssim']:.4f}; peak memory "
          f"{peak / 2**20:.1f} MiB; launches {launches}; app wall "
          f"{wall:.1f} s", flush=True)
    if len(losses) != TRAIN_ITERS or not np.isfinite(losses).all():
        fail(f"{len(losses)} losses, finite: {np.isfinite(losses).all()}")
    if not losses[-1] < losses[0]:
        fail(f"the final loss {losses[-1]} is not below the first "
             f"{losses[0]}")
    if not m["psnr"] >= m["psnr_init"] + 3.0:
        fail(f"PSNR {m['psnr']} is not 3 dB above the untrained map's "
             f"{m['psnr_init']}")
    # K1: the gt renders, the untrained and the final evaluate, and one
    # forward per iteration; K2: one backward per iteration
    want = {"blend_fwd": 3 * n_views + TRAIN_ITERS,
            "blend_bwd": TRAIN_ITERS}
    if launches != want:
        fail(f"launches {launches}, expected {want}")
    return launches


def profile_layers(t, n: int) -> dict:
    """The step's layers over n iterations by torch.profiler: the host time
    of make_train_step's record_function ranges, and the device time of
    the kernels launched inside each (autograd launches the backward's from
    its own thread, so launches are matched to ranges by time); against the
    median unprofiled step of n more iterations (CUDA events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step_ms = float(np.median([cuda_ms(t.train_iteration, reps=1, warmup=0)
                               for _ in range(n)]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t.train(n)
        torch.cuda.synchronize()
    events = prof.events()
    ranges = sorted((e.time_range.start, e.time_range.end,
                     e.name.removeprefix("train_step."))
                    for e in events if e.device_type == DeviceType.CPU
                    and e.name.startswith("train_step."))
    if [r[2] for r in ranges] != list(LAYERS) * n:
        fail(f"the profiler saw the step ranges {[r[2] for r in ranges]}")
    host = dict.fromkeys(LAYERS, 0.0)
    for a, b, name in ranges:
        host[name] += (b - a) / 1e3 / n
    device = dict.fromkeys((*LAYERS, "outside"), 0.0)
    by_kernel = {}
    starts = [r[0] for r in ranges]
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        name = ranges[i][2] if i >= 0 and e.time_range.start <= ranges[i][1] \
            else "outside"
        # a kernel launched outside any torch op (K1 through ctypes) links
        # to the enclosing range itself; the range's own device-side span
        # is not a kernel
        for k in e.kernels:
            if not k.name.startswith("train_step."):
                device[name] += k.duration / 1e3 / n
                by_kernel[k.name] = by_kernel.get(k.name, 0.0) \
                    + k.duration / 1e3 / n
    # every device event once, as a check on the attribution above
    device_events = [e for e in events if e.device_type == DeviceType.CUDA
                     and not e.name.startswith("train_step.")
                     and not getattr(e, "is_user_annotation", False)]
    total = sum(e.time_range.elapsed_us() for e in device_events) / 1e3 / n
    attributed = sum(device.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    print(f"[layers] train step at 256x256 in the frequency-loss window, "
          f"torch.profiler over {n} iterations (ms/iter): host "
          f"{json.dumps({k: round(v, 3) for k, v in host.items()})}; device "
          f"{json.dumps({k: round(v, 4) for k, v in device.items()})}; "
          f"device events {total:.4f} ms/iter, {len(device_events) / n:.0f} "
          f"a step, {attributed:.4f} ms/iter of them matched to a range",
          flush=True)
    print(f"[layers] unprofiled step {step_ms:.3f} ms (CUDA events, median "
          f"of {n}): device busy {100 * total / step_ms:.1f} %; top device "
          f"items (ms/iter): {[(k[:48], round(v, 4)) for k, v in top]}",
          flush=True)
    if not abs(attributed - total) <= 0.05 * total:
        fail(f"{attributed:.4f} ms/iter of kernels matched to launches, "
             f"{total:.4f} ms/iter of device events")
    return {"host": host, "device": device, "step_ms": step_ms}


def phase_trained() -> dict:
    """A second Trainer built with the main path's flags: its step's layers
    inside the frequency-loss window, then K1 and K2 on the inputs that
    24 steps of the trained map give them. Returns the kernels' numbers on
    those inputs (per call, averaged over the steps)."""
    import segs_slam_tpu_torch.ops.rasterizer.blend as blend
    from segs_slam_tpu_torch.apps.train_synthetic import build_trainer

    t, _ = build_trainer(["--iters", str(TRAIN_ITERS), "--freq-reg",
                          "--device", "cuda"])
    # with --iters 300 both frequency terms are on from iteration 51 to 254
    t.train(200)
    profile_layers(t, 10)
    t.train(TRAIN_ITERS - t.iteration)

    # K2's arguments on the next steps, recorded as the step passes them
    captured = []
    backward = blend.blend_backward

    def recording(*args):
        captured.append(args)
        return backward(*args)

    blend.blend_backward = recording
    try:
        t.train(TRAINED_STEPS)
    finally:
        blend.blend_backward = backward
    if len(captured) != TRAINED_STEPS:
        fail(f"{len(captured)} blend backwards in {TRAINED_STEPS} steps")

    g = torch.Generator().manual_seed(SEED + 4)
    equal = dict.fromkeys(("own", "raised"), 0)
    pixels = 0
    worst = dict.fromkeys(("own", "seeded", "clamped"), 0.0)
    k1_err = k2_err = 0.0
    n_clamped = {"own": 0, "raised": 0}
    sums = dict.fromkeys(("k1_ms", "k1_plain_ms", "k2_ms", "k2_plain_ms"),
                         0.0)
    # (bytes, operations) of all the steps together: the bound of a mean
    # call is taken on these, so that it has one side
    work = {"k1": np.zeros(2), "k2": np.zeros(2)}
    with torch.inference_mode():
        for args in captured:
            fargs, (dcolor, ddepth, dfinal_t, final_t, ncontrib) = (
                args[:6], args[6:])
            fwd = check_forward(fargs)
            if not fwd["ok"]:
                fail(f"K1 disagrees with its plain version on a trained "
                     f"step: {fwd['err']}")
            equal["own"] += fwd["equal"]
            pixels += fwd["pixels"]
            k1_err = max(k1_err, fwd["err"]["color"], fwd["err"]["final_T"])
            own = check_backward(args)
            seeded = [torch.randn(x.shape, generator=g).to(x.device)
                      for x in (dcolor, ddepth, dfinal_t)]
            seed_b = check_backward((*fargs, *seeded, final_t, ncontrib))
            # opacities above 0.5 raised to 1: alpha meets the clamp near
            # every such instance's centre
            raised = fargs[0].clone()
            op = raised[blend.F_OP]
            raised[blend.F_OP] = torch.where(op > 0.5, 1.0, op)
            rargs = (raised, *fargs[1:])
            rfwd = check_forward(rargs)
            equal["raised"] += rfwd["equal"]
            clamp_b = check_backward((*rargs, *seeded, rfwd["out"][1],
                                      rfwd["out"][3]))
            for name, res in (("own", own), ("seeded", seed_b),
                              ("clamped", clamp_b)):
                if not res["ok"]:
                    fail(f"K2 disagrees with its plain version on a trained "
                         f"step ({name} cotangents): {res['row_err']}")
                worst[name] = max(worst[name], max(res["row_err"]))
            if not rfwd["ok"]:
                fail(f"K1 disagrees with its plain version with raised "
                     f"opacities: {rfwd['err']}")
            k2_err = max(k2_err, own["max_abs_err"])
            tx = fargs[4]
            pairs = pair_counts(*fargs[:3], ncontrib, tx, t.raster_config)
            n_clamped["own"] += pairs["clamped"]
            n_clamped["raised"] += pair_counts(
                *rargs[:3], rfwd["out"][3], tx, t.raster_config)["clamped"]
            for k, w in zip(("k1", "k2"), blend_work(
                    fargs[1], fargs[2], ncontrib, fargs[0].shape[1], pairs)):
                work[k] += w
            sums["k1_ms"] += cuda_ms(lambda: blend.blend_forward_cuda(*fargs),
                                     reps=5, warmup=1)
            sums["k1_plain_ms"] += cuda_ms(
                lambda: blend.blend_forward_reference(*fargs), reps=1,
                warmup=1)
            sums["k2_ms"] += cuda_ms(lambda: blend.blend_backward_cuda(*args),
                                     reps=5, warmup=1)
            sums["k2_plain_ms"] += cuda_ms(
                lambda: blend.blend_backward_reference(*args), reps=1,
                warmup=1)
    mean = {k: v / TRAINED_STEPS for k, v in sums.items()}
    bounds = {k: bound(w, TRAINED_STEPS) for k, w in work.items()}
    for k, b in bounds.items():
        mean[f"{k}_bound_ms"] = b["bound_ms"]
    agree = {k: v / pixels for k, v in equal.items()}
    print(f"[trained] K1 and K2 on {TRAINED_STEPS} steps of the trained map "
          f"(256x256, NK {captured[0][0].shape[1]}): n_contrib equal on "
          f"{agree['own'] * 100:.4f} % of pixels ({agree['raised'] * 100:.4f}"
          f" % with the opacities raised); worst K2 row error / row max: own "
          f"cotangents {worst['own']:.2e}, seeded {worst['seeded']:.2e}, "
          f"opacities raised {worst['clamped']:.2e}; taken pairs with op G "
          f"above the clamp: {n_clamped['own']} as trained, "
          f"{n_clamped['raised']} raised", flush=True)
    per_call = {k: (w / TRAINED_STEPS).tolist() for k, w in work.items()}
    print(f"[trained] per call, mean of {TRAINED_STEPS} (CUDA events): "
          f"{json.dumps({k: round(v, 4) for k, v in mean.items()})}; bound "
          f"by {({k: b['bound_by'] for k, b in bounds.items()})}; (bytes, "
          f"operations) a call {per_call}", flush=True)
    if min(agree.values()) < 0.9999:
        fail(f"n_contrib equal on only {agree} of the trained steps' pixels")
    if n_clamped["raised"] == 0:
        fail("raising the opacities put no pair above the alpha clamp")
    return {
        "blend_fwd": {"max_abs_err": k1_err, "ms": mean["k1_ms"],
                      "plain_ms": mean["k1_plain_ms"],
                      "bound_ms": mean["k1_bound_ms"],
                      "bound_by": bounds["k1"]["bound_by"],
                      "library_ms": None},
        "blend_bwd": {"max_abs_err": k2_err, "ms": mean["k2_ms"],
                      "plain_ms": mean["k2_plain_ms"],
                      "bound_ms": mean["k2_bound_ms"],
                      "bound_by": bounds["k2"]["bound_by"],
                      "library_ms": None},
    }


def phase_densify():
    from segs_slam_tpu_torch.apps.train_synthetic import build_trainer
    from segs_slam_tpu_torch.train.densify import make_adjust_anchor

    t, _ = build_trainer(["--device", "cuda"])
    # densification four times in 55 iterations; the step bakes its config
    # in, so it is rebuilt
    t.opt_config = dataclasses.replace(
        t.opt_config, start_stat=5, update_from=10, update_interval=10,
        update_until=60)
    t._build_step()
    n0 = int(t.state.anchors.num_active())
    last = t.train(55)
    active = t.state.anchors.active.cpu().numpy()
    n1 = int(active.sum())
    finite = all(bool(torch.isfinite(x).all())
                 for x in t.state.anchors.params().values())
    adjust = make_adjust_anchor(t.model_config, t.opt_config)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    adjust_ms = cuda_ms(lambda: adjust(t.state, gen), reps=1, warmup=0)
    print(f"[densify] 55 iterations, adjust at 20/30/40/50: n_active {n0} "
          f"-> {n1}; last loss {float(last['loss']):.5f}; one more adjust "
          f"{adjust_ms:.3f} ms (CUDA events)", flush=True)
    if not (active[:n1].all() and not active[n1:].any()):
        fail("active slots are not contiguous after densification")
    if not finite:
        fail("non-finite parameters after densification")
    if n1 == n0:
        fail("densification left n_active unchanged")
    if not np.isfinite(float(last["loss"])):
        fail("non-finite loss after densification")
    return adjust_ms


def phase_small_input(dev):
    """The whole render, and one train step, of a small map on the card
    against the CPU path."""
    from segs_slam_tpu_torch.core import Camera, Keyframe
    from segs_slam_tpu_torch.io.convert import (
        anchors_from_numpy,
        decoders_from_jax,
        flatten_params,
    )
    from segs_slam_tpu_torch.models.config import ModelConfig
    from segs_slam_tpu_torch.models.renderer import render
    from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
    from segs_slam_tpu_torch.train.config import OptimizationConfig
    from segs_slam_tpu_torch.train.optimizer import leaves
    from segs_slam_tpu_torch.train.step import (
        init_train_state,
        make_train_step,
    )

    mc = ModelConfig(capacity=256, feat_dim=8, n_offsets=4, appearance_dim=8)
    anchors_np, dec_np = seeded_map(mc, 200, SEED + 1)
    rc = RasterConfig(tile=16, compact=2048, kmax=8, chunk=256, ksmall=4,
                      nlarge=256)
    oc = OptimizationConfig(start_stat=0, high_frequency_regularization_start=0)
    w, h = 96, 64
    cam = Camera(camera_id=0, width=w, height=h, fx=80.0, fy=80.0,
                 cx=w / 2, cy=h / 2)
    kf = Keyframe(kf_id=0, camera=cam, quat=[1, 0, 0, 0], trans=[0, 0, 0])
    gt = np.random.default_rng(SEED + 3).uniform(0, 1, (3, h, w)).astype(
        np.float32)
    images, steps = [], []
    for d in ("cpu", dev):
        cam_d = {k: torch.as_tensor(v, device=d)
                 for k, v in kf.render_inputs().items()}
        bg = torch.tensor([0.1, 0.2, 0.3], device=d)
        with torch.inference_mode():
            images.append(render(
                anchors_from_numpy(anchors_np, d),
                decoders_from_jax(flatten_params(dec_np), d), cam_d, w, h,
                bg, mc, rc))
        ts = init_train_state(anchors_from_numpy(anchors_np, d),
                              decoders_from_jax(flatten_params(dec_np), d),
                              mc)
        ts, m = make_train_step(mc, oc, rc, w, h)(
            ts, cam_d, torch.as_tensor(gt, device=d), bg)
        # the first step's moments are (1 - b1) g: the step's gradients
        steps.append((float(m["loss"]), {
            p: (x / 0.1).cpu() for p, x in leaves(ts.adam.mu)}))
    cpu, gpu = images
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

    (loss_c, g_c), (loss_g, g_g) = steps
    worst = max((float((g_g[p] - g).abs().max())
                 / (float(g.abs().max()) + 1e-12), ".".join(p))
                for p, g in g_c.items())
    print(f"[small] one train step, card vs CPU path: loss {loss_g:.7f} / "
          f"{loss_c:.7f}; worst per-leaf gradient error / leaf max "
          f"{worst[0]:.2e} ({worst[1]})", flush=True)
    if abs(loss_g - loss_c) > 1e-5 * abs(loss_c) or worst[0] > 2e-4:
        fail("the card's train step disagrees with the CPU path")
    if not max(float(g.abs().max()) for g in g_c.values()) > 0:
        fail("the small-input step has no gradient")


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
    phase_kernels(anchors, decoders, mc, rc, dev)
    del anchors, decoders
    phase_render_path(map_path, rc)
    launches = phase_train_path()
    kernels = phase_trained()
    phase_densify()
    phase_small_input(dev)

    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    meta = {
        "blend_fwd": ("segs_slam_tpu_torch/csrc/blend_fwd.cu",
                      "segs_slam_tpu/ops/rasterizer/blend.py:361"),
        "blend_bwd": ("segs_slam_tpu_torch/csrc/blend_bwd.cu",
                      "segs_slam_tpu/ops/rasterizer/blend.py:515"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": meta[name][0],
         "replaces": meta[name][1], "launches": launches[name],
         **kernels[name]} for name in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
