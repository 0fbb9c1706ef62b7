"""Smoke run of the PyTorch + CUDA port (segs_slam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device: a CUDA card must be present; prints the card's name and power
     limit and the torch / CUDA / nvcc versions;
  2. build: compiles kernels K1 (csrc/blend_fwd.cu), K2 (csrc/blend_bwd.cu),
     K3 + K4 (csrc/blend_eval.cu) and K5 (csrc/preprocess.cu) from this
     checkout, one nvcc each, in parallel; prints ptxas registers and
     spills;
  3. kernels: on a full-size 640x480 view of a seeded full-width map, K1
     against its plain PyTorch version on the same binned input (n_contrib
     equal on >= 99.99 % of pixels; there, colour and final_T within 2e-4
     and depth within rtol 1e-4), then K2 against its plain version on the
     same input with seeded colour / depth / final_T cotangents (every
     gradient row within 1e-4 of that row's largest magnitude); then, at
     calibrate_eval_config's sizes for that view, K3 on the pack8 columns of
     the direct selection, K3 on the f16 columns of the compaction branch
     and K4 on its f32 rows, each against its plain version (colour within
     2e-4 on every pixel); each kernel's device time (the mean duration
     torch.profiler records for its __global__ function over at least 20
     recorded launches)
     beside its call time (CUDA events around one wrapper call, host work
     included), its bound, the instances a tile (mean, p99, max) and the
     instances its walk reaches; per-layer breakdowns (CUDA events) of the
     f32 render and of the eval render. Then K5's two entries on that view
     at the main path's shapes (the mask over the 65,536 anchor slots, the
     full entry over the 655,360 gaussian slots) against the eager chain
     compute_cov3d + preprocess_gaussians + blend_inputs, every output bit
     for bit (NaN as NaN); each entry's device time, call time, host time
     and byte bound (42 and 126 B a gaussian), and the chain's device time,
     device operations and host time;
  4. render path: the map rendered by the render_views app (8 orbit views
     at 480x480, calibrate_eval_config + EvalRenderer); images finite, in
     [0, 1] and not blank, K3 launched once per view and no other blend
     kernel, K5 twice a view (prefilter and projection) and twice on each of
     the four calibration views;
     each view against the f32 render of the same view within the pack8
     bound (max 2e-2, mean 1.5e-3) wherever neither path's capacities bind;
     both paths' ms/view;
  5. training path: the train_synthetic app at its full width for 300
     iterations with the frequency losses; the loss finite throughout and
     lower at the end than at the start, the evaluate PSNR at least 3 dB
     above the untrained map's, K2 launched once per iteration and K3 once
     per keyframe in each of the two evaluations, K5 at least once an
     iteration (the prefilter; the training projection keeps the chain);
  6. trained map: a second Trainer built with the same flags. Inside the
     frequency-loss window, the step's layers (inputs, forward, loss,
     backward, stats, Adam, metrics: the train_step.* spans of
     utils/tracing.py) and the device's busy
     share by torch.profiler. After 300 iterations, K1 and K2 against their
     plain versions, at the gates of phase 3, on the inputs of 24 further
     steps: with the loss's own cotangents, with seeded ones, and with the
     opacities above 0.5 raised to 1 so that alpha meets the 0.99 clamp.
     Then evaluate() (K3 once per keyframe, K1 never), K3 against its plain
     version on the 24 keyframes' own inputs, again with the opacities
     raised, and record_all_keyframes' files read back by the harness. The
     kernels' device and call times (as in phase 3, at least 20 recorded
     launches on each input) and bounds on those inputs go into the kernels
     line;
  7. densify: a Trainer at the same width whose densification runs four
     times in 55 iterations; active slots contiguous, parameters finite,
     n_active changed, the loss after it finite; one adjust timed;
  8. small input: the whole render, one train step and the eval render of a
     small map on the card against the CPU path (the plain versions the CPU
     tests hold to the JAX package): images atol 2e-4, per-leaf gradients
     within 2e-4 of the leaf's largest, loss within rtol 1e-5.
  9. SLAM: the online RGB-D mapping path, slam_rgbd with the pose oracle,
     on a 160-frame 640x480 sequence that the port's make_rgbd_dataset
     writes (16 keyframes). Run A at the app's defaults (full width,
     capacity 2^16, packed_train auto) for 1,700 iterations: mapping
     ms/iter and iters/s (host clock around Mapper.run to a synchronised
     device), device time and busy share over a profiler window of 20
     mapper iterations, K1/K2/K3/K5 launches (K5 exactly once in every
     training iteration: the prefilter), the training binning (must be
     the packed one), active anchors, densification adjusts (must be 2),
     record_all_keyframes' PSNR, SSIM, L1 and render FPS read back by the
     harness, ATE against groundtruth.txt (at most 1e-3 m). K1 and K2
     against their plain versions, at phase 6's gates, on 8 of run A's
     steps; the packed against the f32 training binning; pose refinement
     of a perturbed keyframe on the card (the error must fall). Run B with
     pose rows, refinement on arrival, every 25 iterations and at shutdown,
     and two pyramid sub-levels from a YAML, for 550 iterations: the image
     sizes trained (three levels), pose rows folded, refinement gains (none
     negative), finite losses.
 10. apps, in a process of its own (chip_smoke.py --apps, which the
     script starts and waits for): the offline and stereo entry points at
     their full widths, only the frame count and the iteration budget cut.
     10c: train_colmap on
     make_colmap_dataset's scene at both defaults (48 views at 640x480,
     8,000 gaussians, 12,000 sparse points; capacity 2^16, compact 2^16,
     kmax 8, ksmall 4, nlarge 2^13, the f32 training binning), 1,700
     iterations with --out: ms/iter, evaluate() PSNR and SSIM before and
     after training (the gain must be at least 3 dB), active anchors after
     the two densify adjusts, every step on the f32 binning with K1 and K2,
     K3 once per keyframe in the app's evaluation (the untrained map's
     evaluation is this script's and its launches are counted apart), the
     --out train state reloaded equal, and K1/K2 against their plain
     versions on 8 of its steps at phase 6's gates. 10d: slam_stereo
     --pre-rectified --tracker oracle on make_stereo_dataset's sequence at
     both defaults (120 pairs at 640x480, baseline 0.11; kmax 16, the packed
     training binning), 600 iterations: ms/iter, every step on the packed
     binning with K1 and K2, finite losses, PSNR, SSIM and L1 of the
     keyframes (K3), ATE against the loader's ground truth (at most 1e-3 m),
     the SGM pseudo-depth's valid share, and K1/K2 against their plain
     versions on 8 of its steps at phase 6's gates. The native
     tracker's runs (slam_rgbd --tracker native, slam_mono) are not here:
     the card's host has no OpenCV 4 to build the tracker against.
 11. the last modules, in a process of its own (chip_smoke.py --last),
     each path read with the launch counts set to 0 just before it.
     11a: the viewer app in checkpoint mode on 10c's --out train state,
     served on a free port: /, /state and 20 /render requests on an orbit
     at 480x480 (JPEGs of 480x480x3, K3 once a request); one frame before
     JPEG against the same pose rendered with K3's plain version (at most
     one 8-bit level apart); ms a request; K3 against its plain version on
     the frame's binned input. 11b: slam_rgbd --tracker oracle on phase 9's
     sequence, 300 iterations without and then with --viewer-port, a
     client requesting /render every 100 ms meanwhile: every response 200
     and a 480x480 frame, no render-thread error, finite losses; ms a
     request and mapping ms/iter of both runs. 11c: rasterize(shs=...) at
     degree 3 on phase 3's 640x480 view with seeded coefficients (the
     map's opacities scaled by 4, so that alpha can reach the clamp), forward
     and backward through K1 and K2, against the same call through the
     plain versions on the card (image within 2e-4 where n_contrib is
     equal on >= 99.99 % of pixels, gradients within 2e-4 of their
     largest), and K1/K2 against their plain versions on its binned input
     at phase 6's gates. 11d: the eval render of 10c's trained map with
     kanchor = n_offsets - 2 (the direct selection, pack8): K3 against its
     plain version, the anchors that overflow kanchor, the binned columns
     equal to those without kanchor where none does. 11e: evaluate_run's
     lpips column over 4 of run A's keyframe pairs with random
     AlexNet-shaped weights (SEGS_LPIPS_WEIGHTS): the card against the CPU
     within rel 2e-4. 11f: two gloo ranks on the card (chip_smoke.py
     --dp-rank R WORK), one make_dp_train_step each on train_synthetic's
     first keyframe at 256x256, replicated: the update equal to the
     single-process step's (rtol 1e-4, atol 1e-5), the densify statistics'
     deltas twice its, the ranks equal; each rank's launches and the
     step's ms.
Then ranks the kernels by the device time the main path loses in them
(launches x (device ms - bound ms)) and prints a JSON line with each
kernel's numbers ("ms" is its device time, "call_ms" its call time,
"pixels_per_thread" the pixels a thread of the instance its wrapper
launched on those inputs; K1's and K2's numbers on phase 10's steps and
11c's, K3's on 11a's and 11d's inputs, under "numbers_by_path"), then, as
the last line, {"ok": true, "device":
{...}}. Imports nothing of JAX.
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
LIBRARIES = ("blend_fwd", "blend_bwd", "blend_eval",
             "preprocess")  # csrc/<name>.cu
# the kernels line's entries: (source, TPU kernel replaced)
KERNELS = {
    "blend_fwd": ("segs_slam_tpu_torch/csrc/blend_fwd.cu",
                  "segs_slam_tpu/ops/rasterizer/blend.py:361"),
    "blend_bwd": ("segs_slam_tpu_torch/csrc/blend_bwd.cu",
                  "segs_slam_tpu/ops/rasterizer/blend.py:515"),
    "blend_eval_packed": ("segs_slam_tpu_torch/csrc/blend_eval.cu",
                          "segs_slam_tpu/ops/rasterizer/blend.py:252"),
    "blend_eval": ("segs_slam_tpu_torch/csrc/blend_eval.cu",
                   "segs_slam_tpu/ops/rasterizer/blend.py:720"),
    # no Pallas kernel: XLA fuses the jnp preprocess inside its jit
    "preprocess": ("segs_slam_tpu_torch/csrc/preprocess.cu", "none"),
}
# the tile-blend kernels, which the rankings compare
BLEND_KERNELS = ("blend_fwd", "blend_bwd", "blend_eval_packed", "blend_eval")

# each kernel's __global__ function, as the profiler names its launches
KERNEL_FUNCS = {"blend_fwd": "blend_fwd_kernel",
                "blend_bwd": "blend_bwd_kernel",
                "blend_eval_packed": "blend_eval_kernel",
                "blend_eval": "blend_eval_kernel",
                "preprocess": "preprocess_kernel"}
DEVICE_REPS = 20  # recorded launches an input for a kernel's device ms

TRAINED_STEPS = 24
LAYERS = ("inputs", "forward", "loss", "backward", "stats", "adam",
          "metrics")
# the port's span names (utils/tracing.py): their device-side annotation
# ranges are not kernels
SPAN_PREFIXES = ("train_step.", "render.", "mapper.")

# The SLAM phase: slam_rgbd with the pose oracle on the port's
# make_rgbd_dataset sequence, frames cut from 200 to 160 (16 keyframes)
SLAM_FRAMES = 160
SLAM_ITERS = 1700  # from 30,000: densification adjusts at 1,600 and 1,700
# run B: --pose-refine-every fires from its warm-up (iteration 500) on
SLAM_B_ITERS = 550
SLAM_WINDOW = (1001, 20)  # profiler window: first iteration, iterations
SLAM_CHECKED = (1651, 8)  # K1/K2 against plain: first iteration, steps
PYRAMID_YAML = ("%YAML:1.0\nGausPyramid.do: 1\n"
                "GausPyramid.num_sub_levels: 2\n")
# Phase 10: train_colmap cut from 30,000 to 1,700 iterations, so that
# densification adjusts at 1,600 and 1,700 (update_from 1,500, interval
# 100, as in run A); slam_stereo cut from 30,000 to 600
COLMAP_ITERS = 1700
COLMAP_CHECKED = (1651, 8)  # K1/K2 against plain: first iteration, steps
STEREO_ITERS = 600
STEREO_CHECKED = (551, 8)  # K1/K2 against plain: first iteration, steps

# For the bounds: H100 SXM HBM3 rate and FP32 peak outside the tensor cores
# (NVIDIA's data sheet, 700 W), and the FP32 operations per (pixel,
# instance) pair, counted from the sources with a multiply-add as two and
# expf or a division as one. Every pair a kernel must test costs the offset
# (2), the EWA exponent (9) and the power test (1). A pair the pixel takes
# (it passed the skips and lies below its n_contrib) costs besides: in K1,
# exp, op G, the clamp, the alpha test, T (1 - alpha), the latch test, w
# and four weighted sums (16); in K2, exp, op G, the clamp, the alpha test,
# 1 - alpha, T recovery, w, g (7), dpower (4), S (2), the ten gradient
# values (20) and their sums over the tile's pixels (10) (50); in K3 and K4,
# K1's less the depth sum (14). K3 reads 20 B an instance (five u32
# columns) or 16 B (pack8's four), K4 36 B (nine f32 rows).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_TEST = 12
K1_OPS_PER_TAKE = 16
K2_OPS_PER_TAKE = 50
EVAL_OPS_PER_TAKE = K1_OPS_PER_TAKE - 2
# the eval pack8 bound against the f32 render (tests/test_packed_binning.py)
PACK8_MAX, PACK8_MEAN = 2e-2, 1.5e-3


def fail(msg: str):
    # on both streams: a caller that keeps only the end of one still sees it
    print(f"chip_smoke FAILED: {msg}", flush=True)
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of `reps` CUDA-event timings of one fn() call, after warm-up:
    for a kernel, its wrapper's call_ms (host work included)."""
    from segs_slam_tpu_torch.utils.kernel_timing import event_ms

    return event_ms(fn, reps, warmup)


def kernel_ms(calls, name: str) -> float:
    """A kernel's device time alone (ms): the mean duration of the CUDA
    kernels named `name` (csrc's __global__ function) that torch.profiler
    records over at least DEVICE_REPS launches on each of `calls`."""
    from segs_slam_tpu_torch.utils.kernel_timing import device_ms

    try:
        return device_ms(calls, name, reps=DEVICE_REPS)
    except RuntimeError as e:
        fail(str(e))


def bound(work: tuple[float, float], calls: int = 1) -> dict:
    """The least time the card could take for one of `calls` calls that
    together move work = (bytes, FP32 operations): the larger of the bytes
    over the memory rate and the operations over the FP32 peak."""
    t_bytes = work[0] / HBM_BYTES_PER_S * 1e3 / calls
    t_ops = work[1] / FP32_OPS_PER_S * 1e3 / calls
    return {"bound_ms": float(max(t_bytes, t_ops)),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def pair_counts(feats, tile_start, tile_stop, ncontrib, tiles_x, rc,
                tile_local: bool = False) -> dict:
    """The (pixel, instance) pairs of one binned view, from the plain
    version's per-pair alphas and K1's n_contrib: `taken` (the pixel takes
    the instance), `clamped` (taken, with op G above the 0.99 clamp),
    `fwd_tested` (what K1 must test: every instance of the tile up to the
    one at which the pixel latches, or all of them), `bwd_tested` (what
    K2 must test: the instances below the pixel's n_contrib) and
    `fwd_walked` (the instances K1 must walk: over the tiles, the most that
    one pixel of the tile tests)."""
    from segs_slam_tpu_torch.ops.rasterizer.blend import (
        _group_alpha,
        _tile_groups,
    )

    counts = (tile_stop - tile_start).tolist()
    n = dict.fromkeys(("fwd_tested", "bwd_tested", "taken", "clamped",
                       "fwd_walked"), 0)
    for t0, t1, length in _tile_groups(counts, rc.tile * rc.tile):
        _, inside, _, _, _, opg, alpha = _group_alpha(
            feats, tile_start, counts, t0, t1, length, tiles_x, rc,
            tile_local)
        below = (torch.arange(length, device=feats.device)
                 < ncontrib[t0:t1, 0, :, None])
        taken = below & (alpha > 0.0)
        cum = torch.cumprod(1.0 - alpha, dim=-1)
        t_before = torch.cat([torch.ones_like(cum[..., :1]), cum[..., :-1]],
                             -1)
        tested = (inside[:, None, :]
                  & (t_before >= rc.transmittance_min)).sum(-1)
        n["fwd_tested"] += int(tested.sum())
        n["fwd_walked"] += int(tested.amax(-1).sum())
        n["bwd_tested"] += int(below.sum())
        n["taken"] += int(taken.sum())
        n["clamped"] += int((taken & (opg > rc.alpha_clamp)).sum())
    return n


def blend_work(tile_start, tile_stop, ncontrib, nk, pairs):
    """K1's and K2's (bytes, FP32 operations) on one binned view, and the
    instances K2 walks (each tile's up to its largest n_contrib). K1 reads
    each instance of a tile range once (40 B), the tile ranges and bg, and
    writes 24 B a pixel; K2 reads the instances up to its tile's largest
    n_contrib, 28 B of cotangents and forward outputs a pixel, and writes
    the [10, NK] gradient array once."""
    nt, npix = ncontrib.shape[0], ncontrib.shape[2]
    counts = (tile_stop - tile_start).long()
    walked = int(torch.minimum(ncontrib.reshape(nt, -1).amax(dim=1).long(),
                               counts).sum())
    k1 = (int(counts.sum()) * 40 + nt * 8 + 12 + nt * npix * 24,
          OPS_PER_TEST * pairs["fwd_tested"]
          + K1_OPS_PER_TAKE * pairs["taken"])
    k2 = (walked * 40 + nt * npix * 28 + nt * 8 + 12 + 40 * nk,
          OPS_PER_TEST * pairs["bwd_tested"]
          + K2_OPS_PER_TAKE * pairs["taken"])
    return (k1, k2), walked


def eval_work(tile_start, tile_stop, npix, bytes_per_instance, pairs):
    """An eval kernel's (bytes, FP32 operations) on one binned view: each
    instance of a tile range read once, the tile ranges and bg, 12 B of
    colour written a pixel; 12 operations a tested pair and 14 a taken
    one."""
    nt = tile_start.shape[0]
    n = int((tile_stop - tile_start).sum())
    return (n * bytes_per_instance + nt * 8 + 12 + nt * npix * 12,
            OPS_PER_TEST * pairs["fwd_tested"]
            + EVAL_OPS_PER_TAKE * pairs["taken"])


def eval_input(kind, x, rc):
    """What an eval kernel's plain version composites: (f32 rows, whether
    mean2d is tile-local, bytes an instance) for K3's columns (int32) or
    K4's rows."""
    from segs_slam_tpu_torch.ops.rasterizer.blend import decode_eval_columns

    if kind == "blend_eval":
        return x, False, 36
    return decode_eval_columns(x, rc.pack8), True, 4 * x.shape[0]


def check_eval(kind, args) -> dict:
    """K3 (kind blend_eval_packed) or K4 (blend_eval) against its plain
    version on one binned input (x, tile_start, tile_stop, bg, tiles_x,
    config): colour within 2e-4 on every pixel. Also the input's (pixel,
    instance) pairs, its (bytes, operations), and how far the latch cuts
    the pairs a pixel tests (the plain version's T)."""
    import segs_slam_tpu_torch.ops.rasterizer.blend as blend

    kernel, plain = {
        "blend_eval_packed": (blend.blend_forward_eval_packed_cuda,
                              blend.blend_forward_eval_packed_reference),
        "blend_eval": (blend.blend_forward_eval_cuda,
                       blend.blend_forward_eval_reference)}[kind]
    x, start, stop, bg, tx, rc = args
    ref = plain(*args)
    got = kernel(*args)
    err = float((got - ref).abs().max())
    rows, local, nbytes = eval_input(kind, x, rc)
    _, _, _, ncontrib = blend._forward_reference(
        rows, start, stop, bg, tx, rc, tile_local=local, with_depth=False)
    npix = rc.tile * rc.tile
    pairs = pair_counts(rows, start, stop, ncontrib, tx, rc, local)
    in_range = int((stop - start).sum()) * npix
    return {"out": got, "max_abs_err": err, "pairs": pairs,
            "work": eval_work(start, stop, npix, nbytes, pairs),
            "tested_share": pairs["fwd_tested"] / max(in_range, 1),
            "ok": err <= 2e-4 and bool(torch.isfinite(got).all())}


def pixels_per_thread(tile_start, eval_kernel: bool = False) -> int:
    """The pixels a thread that a kernel's wrapper launches with on a
    binned view of tile_start.shape[0] tiles (K3 and K4: eval_kernel)."""
    import segs_slam_tpu_torch.ops.rasterizer.blend as blend

    return blend._pixels_per_thread(
        tile_start.shape[0],
        blend._MANY_EVAL_TILES if eval_kernel else blend._MANY_TILES)


def raise_opacity(x, rc):
    """The eval input with every opacity above 0.5 raised to 1 (alpha then
    meets the 0.99 clamp near each such instance's centre)."""
    from segs_slam_tpu_torch.ops.rasterizer.binning import _f16_from_bits
    from segs_slam_tpu_torch.ops.rasterizer.blend import F_OP

    x = x.clone()
    if x.dtype == torch.float32:  # K4's rows
        x[F_OP] = torch.where(x[F_OP] > 0.5, 1.0, x[F_OP])
        return x
    if rc.pack8:  # 11-bit opacity in column 2, bits 16..26
        q = (x[2] >> 16) & 0x7FF
        x[2] = torch.where(q > 1023, x[2] | (0x7FF << 16), x[2])
        return x
    op = _f16_from_bits(x[2].to(torch.int64) >> 16)  # f16, high half
    one = 0x3C00 << 16  # f16 1.0
    x[2] = torch.where(op > 0.5, (x[2] & 0xFFFF) | one, x[2])
    return x


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
    import importlib

    import segs_slam_tpu_torch.ops.rasterizer.blend as blend

    rasterize = importlib.import_module(
        "segs_slam_tpu_torch.ops.rasterizer.rasterize")
    return {"blend_fwd": blend.blend_forward_cuda,
            "blend_bwd": blend.blend_backward_cuda,
            "blend_eval_packed": blend.blend_forward_eval_packed_cuda,
            "blend_eval": blend.blend_forward_eval_cuda,
            "preprocess": rasterize.preprocess_cuda}


def blend_launches(launches: dict) -> dict:
    """The tile-blend kernels' entries of a launch count."""
    return {k: launches[k] for k in BLEND_KERNELS}


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
    f32_matmuls()


def f32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False  # decoders, SSIM in f32
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from segs_slam_tpu_torch.ops.cuda_lib import build_library, load_library

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as ex:
        libs = dict(zip(LIBRARIES, ex.map(build_library, LIBRARIES)))
    for name, lib in libs.items():
        load_library(name)
        print(f"[build] {name}: {lib.name}", flush=True)
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}", flush=True)
    print(f"[build] K1, K2, K3 + K4, K5 in {time.perf_counter() - t0:.2f} s",
          flush=True)


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
    from segs_slam_tpu_torch.utils.kernel_timing import tile_counts

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
        k1_call_ms = cuda_ms(lambda: blend_forward_cuda(*args), reps=20,
                             warmup=3)
        k1_ms = kernel_ms([lambda: blend_forward_cuda(*args)],
                          KERNEL_FUNCS["blend_fwd"])
        k1_plain_ms = cuda_ms(lambda: blend_forward_reference(*args),
                              reps=10)
    layer_ms["blend_K1"] = k1_call_ms

    agree = fwd["equal"] / fwd["pixels"]
    counts = tile_counts(b.tile_start, b.tile_stop)
    n_inst = counts["total"]
    print(f"[kernel] 640x480, {nt} tiles, NK {b.feats_sorted.shape[1]}, "
          f"{n_inst} instances, num_compact {int(stages['compact'].num_valid)}"
          f" of {rc.compact}; instances a tile: mean {counts['mean']:.1f}, "
          f"p99 {counts['p99']:.1f}, max {counts['max']}; n_contrib equal on "
          f"{agree * 100:.4f} % of pixels; max |err| {fwd['err']}",
          flush=True)
    print(f"[kernel] K1 device {k1_ms:.4f} ms (profiler, mean of "
          f"{DEVICE_REPS}+), call {k1_call_ms:.4f} ms, plain {k1_plain_ms:.3f}"
          f" ms (CUDA events, median)", flush=True)
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
        k2_call_ms = cuda_ms(lambda: blend_backward_cuda(*bargs), reps=20,
                             warmup=3)
        k2_ms = kernel_ms([lambda: blend_backward_cuda(*bargs)],
                          KERNEL_FUNCS["blend_bwd"])
        k2_plain_ms = cuda_ms(lambda: blend_backward_reference(*bargs),
                              reps=5)
        pairs = pair_counts(*args[:3], got[3], tx, rc)
    print(f"[kernel] K2 device {k2_ms:.4f} ms (profiler, mean of "
          f"{DEVICE_REPS}+), call {k2_call_ms:.4f} ms, plain {k2_plain_ms:.3f}"
          f" ms (CUDA events, median); per-row max |err| / row max: "
          f"{[f'{e:.2e}' for e in bwd['row_err']]}", flush=True)
    if bwd["zero_rows"]:
        fail("a K2 gradient row is all zeros on the kernel-phase view")
    if not bwd["ok"]:
        fail(f"K2 disagrees with its plain version: {bwd['row_err']}")
    (k1_work, k2_work), k2_walked = blend_work(
        b.tile_start, b.tile_stop, got[3], b.feats_sorted.shape[1], pairs)
    k1_bound, k2_bound = bound(k1_work), bound(k2_work)
    print(f"[kernel] bounds: K1 {k1_bound['bound_ms']:.4f} ms "
          f"({k1_bound['bound_by']}), K2 {k2_bound['bound_ms']:.4f} ms "
          f"({k2_bound['bound_by']}); instances walked: K1 "
          f"{pairs['fwd_walked']}, K2 {k2_walked} of {n_inst}; (pixel, "
          f"instance) pairs {pairs}", flush=True)
    ppt = pixels_per_thread(b.tile_start)
    return {"blend_fwd": {"ms": k1_ms, "call_ms": k1_call_ms,
                          "plain_ms": k1_plain_ms, **k1_bound,
                          "pixels_per_thread": ppt},
            "blend_bwd": {"ms": k2_ms, "call_ms": k2_call_ms,
                          "plain_ms": k2_plain_ms, **k2_bound,
                          "pixels_per_thread": ppt}}


def phase_eval_kernels(anchors, decoders, mc, rc, dev) -> dict:
    """K3 (pack8 and f16 columns) and K4 against their plain versions on
    the kernel phase's 640x480 view, at calibrate_eval_config's sizes for
    that view, and the layers of one eval render. Returns each input's
    numbers (K4's go into the kernels line: no main path runs K4)."""
    import segs_slam_tpu_torch.ops.rasterizer.binning as binning
    from segs_slam_tpu_torch.core import Camera, Keyframe
    from segs_slam_tpu_torch.models.renderer import (
        calibrate_eval_config,
        neural_gaussians_for_view,
    )
    from segs_slam_tpu_torch.ops.rasterizer.blend import (
        blend_forward_eval_cuda,
        blend_forward_eval_packed_cuda,
        blend_forward_eval_packed_reference,
        blend_forward_eval_reference,
    )
    from segs_slam_tpu_torch.ops.rasterizer.rasterize import project
    from segs_slam_tpu_torch.utils.kernel_timing import tile_counts

    w, h = 640, 480
    cam = Camera(camera_id=0, width=w, height=h, fx=500.0, fy=500.0,
                 cx=w / 2, cy=h / 2)
    kf = Keyframe(kf_id=0, camera=cam, quat=[1, 0, 0, 0], trans=[0, 0, 0])
    c = {k: torch.as_tensor(v, device=dev)
         for k, v in kf.render_inputs().items()}
    bg = torch.tensor([0.25, 0.5, 0.75], device=dev)
    cal = calibrate_eval_config(rc, mc, anchors, decoders, [c], w, h)
    f16 = dataclasses.replace(cal, sel_direct=False, pack8=False)
    tx, ty = cal.grid(w, h)
    print(f"[eval] 640x480 calibrated eval config: ksmall {cal.ksmall}, kmid "
          f"{cal.kmid}, nmid {cal.nmid}, nlarge {cal.nlarge}, compact "
          f"{cal.compact}, NK {cal.max_instances}", flush=True)

    stages = {}

    def decode():
        stages["decode"] = neural_gaussians_for_view(
            anchors, decoders, c, w, h, mc, cal)[1]

    def preprocess():
        ng = stages["decode"]
        stages["preprocess"] = project(
            ng.xyz, ng.scaling, ng.rotation, ng.opacity, ng.color,
            c["world_view_transform"], c["full_proj_transform"], w, h,
            c["tan_fovx"], c["tan_fovy"], cal, ng.valid)[1:]

    def binning_all():
        stages["binning"] = binning.bin_eval_direct(
            *stages["preprocess"], tx, ty, cal, return_packed=True)

    with torch.inference_mode():
        layer_ms = {name: cuda_ms(fn, reps=10) for name, fn in (
            ("decode", decode), ("preprocess", preprocess),
            ("binning", binning_all))}
        # the binning's two sorts alone, on this view's keys
        feats, aux = stages["preprocess"]
        pays, dmeta, ok, opac_q, _ = binning._pack_eval_cols(feats, aux, cal)
        sel_key = torch.where(
            ok, ((cal.kmax - binning._touched(dmeta)) << 16) | opac_q,
            binning._SEL_DEAD)
        sel = torch.sort(sel_key, stable=True).indices
        ukey = binning._expand_tiers(pays, dmeta, sel[:cal.compact], sel, tx,
                                     tx * ty, cal)[0][0]
        layer_ms["selection_sort"] = cuda_ms(
            lambda: torch.sort(sel_key, stable=True), reps=10)
        layer_ms["instance_sort"] = cuda_ms(
            lambda: torch.sort(ukey, stable=True), reps=10)

        cols, start, stop, n_inst, n_valid = stages["binning"]
        pc = binning.compact_gaussians_packed(feats, aux, f16)
        inputs = {
            "K3 pack8": ("blend_eval_packed", blend_forward_eval_packed_cuda,
                         blend_forward_eval_packed_reference,
                         (binning.as_u32_bits(cols), start, stop, bg, tx,
                          cal)),
            "K3 f16": ("blend_eval_packed", blend_forward_eval_packed_cuda,
                       blend_forward_eval_packed_reference),
            "K4": ("blend_eval", blend_forward_eval_cuda,
                   blend_forward_eval_reference),
        }
        c16, s16, e16, _, _ = binning.expand_and_sort_packed(
            pc, tx, ty, f16, return_packed=True)
        inputs["K3 f16"] += ((binning.as_u32_bits(c16), s16, e16, bg, tx,
                              f16),)
        f32, s32, e32, _, _ = binning.expand_and_sort_packed(pc, tx, ty, f16)
        inputs["K4"] += ((f32, s32, e32, bg, tx, f16),)
        results = {}
        for name, (kind, kernel, plain, args) in inputs.items():
            res = check_eval(kind, args)
            torch.cuda.synchronize()
            res["call_ms"] = cuda_ms(lambda: kernel(*args), reps=20,
                                     warmup=3)
            res["ms"] = kernel_ms([lambda: kernel(*args)],
                                  KERNEL_FUNCS[kind])
            res["plain_ms"] = cuda_ms(lambda: plain(*args), reps=5)
            res["tiles"] = tile_counts(args[1], args[2])
            res["pixels_per_thread"] = pixels_per_thread(args[1], True)
            res.update(bound(res["work"]))
            results[name] = res
        layer_ms["K3"] = results["K3 pack8"]["call_ms"]

    print(f"[eval] 640x480: {int(n_inst)} instances of NK {cols.shape[1]}, "
          f"{int(n_valid)} live gaussians for compact {cal.compact}; layers "
          f"of the eval render (ms, CUDA events, median of 10; binning = "
          f"packing + selection sort + expansion + instance sort): "
          f"{json.dumps({k: round(v, 4) for k, v in layer_ms.items()})}",
          flush=True)
    for name, r in results.items():
        tc = r["tiles"]
        print(f"[eval] {name}: P {r['pixels_per_thread']}, device "
              f"{r['ms']:.4f} ms (profiler, mean of {DEVICE_REPS}+), call "
              f"{r['call_ms']:.4f} ms, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}); max |err| {r['max_abs_err']:.3g}; "
              f"instances a tile: mean {tc['mean']:.1f}, p99 {tc['p99']:.1f},"
              f" max {tc['max']}, walked {r['pairs']['fwd_walked']} of "
              f"{tc['total']}; pairs {r['pairs']}; the latch leaves "
              f"{100 * r['tested_share']:.2f} % of the (pixel, instance) "
              f"pairs in range to test", flush=True)
    for name, r in results.items():
        if not r["ok"]:
            fail(f"{name} disagrees with its plain version: max |err| "
                 f"{r['max_abs_err']}")
    if int(n_inst) == 0:
        fail("the eval kernel view binned no instances")
    return {name: {k: r[k] for k in ("max_abs_err", "ms", "call_ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "pixels_per_thread")}
            for name, r in results.items()}


def phase_preprocess_kernel(anchors, decoders, mc, rc, dev) -> dict:
    """K5's two entries against the eager chain on the kernel phase's
    640x480 view at the main path's shapes (the anchor prefilter's mask
    over every anchor slot, the projection over every gaussian slot), every
    output bit for bit; their times beside the chain's (see
    tools/preprocess_ab.py). Returns the kernels line's entry: the full
    entry's numbers, the mask's and the chain's under "entries"."""
    from types import SimpleNamespace

    from segs_slam_tpu_torch.core import Camera, Keyframe
    from segs_slam_tpu_torch.tools import preprocess_ab

    w, h = 640, 480
    cam = Camera(camera_id=0, width=w, height=h, fx=500.0, fy=500.0,
                 cx=w / 2, cy=h / 2)
    kf = Keyframe(kf_id=0, camera=cam, quat=[1, 0, 0, 0], trans=[0, 0, 0])
    c = {k: torch.as_tensor(v, device=dev)
         for k, v in kf.render_inputs().items()}
    scene = SimpleNamespace(state=anchors, decoders=decoders, w=w, h=h,
                            mc=mc, rc=rc)
    mask_args, full_args = preprocess_ab.k5_inputs(scene, c)
    diff = preprocess_ab.k5_differences(mask_args, full_args)
    with torch.no_grad():
        alive = int((preprocess_ab.chain(full_args)[0].radius > 0).sum())
        visible = int(preprocess_ab.chain(mask_args).sum())
    nums = preprocess_ab.k5_numbers(mask_args, full_args)
    for entry, r in nums.items():
        ch = r["chain"]
        print(f"[preprocess] K5 {entry} entry, {r['gaussians']} gaussians: "
              f"device {r['ms']:.4f} ms (profiler, mean of {DEVICE_REPS}+), "
              f"call {r['call_ms']:.4f} ms, host {r['host_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.5f} ms (bytes); the eager chain: "
              f"device {ch['device_ms']:.4f} ms in {ch['device_ops']:.0f} "
              f"device operations, host {ch['host_ms']:.3f} ms", flush=True)
    print(f"[preprocess] against the chain: {visible} anchors visible, "
          f"{alive} gaussians alive; differing elements {diff}", flush=True)
    if any(diff.values()):
        fail(f"K5 differs from the eager chain: {diff}")
    if not (visible and alive):
        fail("the K5 view saw no anchor or no gaussian")
    full = nums["full"]
    return {"ms": full["ms"], "call_ms": full["call_ms"],
            "bound_ms": full["bound_ms"], "bound_by": "bytes",
            "entries": nums}


def live_and_large(anchors, decoders, mc, rc, cam, w, h):
    """A view's live gaussians and those whose kmax-clamped footprint
    exceeds ksmall and kmid: what the compaction and the tiers must hold."""
    from segs_slam_tpu_torch.models.renderer import project_view

    _, neural, proj, _, _ = project_view(anchors, decoders, cam, w, h, mc, rc)
    t = torch.where((proj.radius > 0) & neural.valid,
                    torch.clamp(proj.tiles_touched, max=rc.kmax), 0)
    return (int((t > 0).sum()), int((t > rc.ksmall).sum()),
            int((t > rc.kmid).sum()) if rc.kmid else 0)


def phase_render_path(map_path, rc, mc):
    """render_views (calibrate_eval_config + EvalRenderer, K3), then each
    view again through the f32 render (K1) at the app's training config."""
    from segs_slam_tpu_torch.apps import render_views
    from segs_slam_tpu_torch.core import Camera, Keyframe
    from segs_slam_tpu_torch.io.convert import load_map
    from segs_slam_tpu_torch.models.renderer import EvalRenderer, render

    out_dir = WORK / "views"
    size = 480
    argv = ["--map", str(map_path), "--out", str(out_dir), "--size",
            str(size), "--orbit-frames", str(N_VIEWS), "--compact",
            str(rc.compact), "--kmax", str(rc.kmax), "--ksmall",
            str(rc.ksmall), "--nlarge", str(rc.nlarge), "--device", "cuda"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    # K5's launches in each view's render (the rest: the calibration's)
    k5_views = []
    counts = EvalRenderer.render_with_counts

    def render_with_counts(self, *a, **kw):
        k5 = launch_counters()["preprocess"]
        before = k5.launches
        out = counts(self, *a, **kw)
        k5_views.append(k5.launches - before)
        return out

    EvalRenderer.render_with_counts = render_with_counts
    try:
        views = render_views.main(argv)
    finally:
        EvalRenderer.render_with_counts = counts
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    if len(views) != N_VIEWS:
        fail(f"render_views returned {len(views)} views, not {N_VIEWS}")
    for i, v in enumerate(views):
        img = v["image"]
        if img.shape != (3, size, size) or not np.isfinite(img).all():
            fail(f"view {i}: shape {img.shape} or non-finite values")
        if img.min() < 0.0 or img.max() > 1.0 + 1e-6:
            fail(f"view {i} outside [0, 1]: {img.min()} .. {img.max()}")
        if img.max() - img.min() < 0.05:
            fail(f"view {i} is blank (range {img.max() - img.min()})")
        if not (out_dir / f"view{i:04d}.png").is_file():
            fail(f"view {i} PNG missing")
    want = dict.fromkeys(KERNELS, 0)
    want["blend_eval_packed"] = N_VIEWS
    # two a view, and two on each of render_views' four calibration views
    want["preprocess"] = 2 * (N_VIEWS + 4)
    if launches != want or k5_views != [2] * N_VIEWS:
        fail(f"launches {launches} for {N_VIEWS} views, expected {want}; "
             f"K5 a view {k5_views}")
    cal = views[0]["raster_config"]
    ms = [v["ms"] for v in views]
    print(f"[render] render_views: {N_VIEWS} views at {size}x{size} through "
          f"EvalRenderer (K3), ms/view "
          f"{json.dumps([round(x, 3) for x in ms])}; mean {np.mean(ms):.3f} "
          f"ms, mean without the first {np.mean(ms[1:]):.3f} ms "
          f"({1000 / np.mean(ms[1:]):.1f} FPS); peak memory "
          f"{peak / 2**20:.1f} MiB; launches {launches}", flush=True)
    print(f"[render] calibrated eval config: ksmall {cal.ksmall}, kmid "
          f"{cal.kmid}, nmid {cal.nmid}, nlarge {cal.nlarge}, compact "
          f"{cal.compact}; num_compact {[v['num_compact'] for v in views]}; "
          f"num_instances {[v['num_instances'] for v in views]} of "
          f"{cal.max_instances}", flush=True)

    # the same views through the f32 render (K1): timed at the app's
    # training config (the render_views of earlier versions), and held at
    # the flat (single-tier) config, whose only capacity is the compaction
    dev = torch.device("cuda")
    anchors, decoders = load_map(map_path, dev)
    camera = Camera(camera_id=0, width=size, height=size, fx=0.9 * size,
                    fy=0.9 * size, cx=size / 2, cy=size / 2)
    bg = torch.zeros(3, device=dev)
    flat = dataclasses.replace(rc, ksmall=0, nlarge=0)
    f32_ms, diffs, gated = [], [], 0
    with torch.inference_mode():
        for i, v in enumerate(views):
            q, t = v["pose"]
            kf = Keyframe(kf_id=i, camera=camera, quat=q, trans=t)
            cam = {k: torch.as_tensor(x, device=dev)
                   for k, x in kf.render_inputs().items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(anchors, decoders, cam, size, size, bg, mc, rc).image.cpu()
            f32_ms.append((time.perf_counter() - t0) * 1e3)
            exact = render(anchors, decoders, cam, size, size, bg, mc,
                           flat).image.cpu().numpy()
            d = np.abs(v["image"] - exact)
            live, over_ks, over_kmid = live_and_large(anchors, decoders, mc,
                                                      cal, cam, size, size)
            binds = [name for name, b in (
                ("compact", live > cal.compact), ("nmid", over_ks > cal.nmid),
                ("nlarge", over_kmid > cal.nlarge)) if b]
            diffs.append((round(float(d.max()), 6), round(float(d.mean()), 7),
                          live, over_ks, over_kmid, binds))
            if not binds:
                gated += 1
                if d.max() > PACK8_MAX or d.mean() > PACK8_MEAN:
                    fail(f"view {i}: eval render off the f32 render by max "
                         f"{d.max():.4g}, mean {d.mean():.4g}")
    print(f"[render] the same views through render (K1) at the training "
          f"config, ms/view {json.dumps([round(x, 3) for x in f32_ms])}; "
          f"mean without the first {np.mean(f32_ms[1:]):.3f} ms against the "
          f"eval path's {np.mean(ms[1:]):.3f} ms (host clock to the image on "
          f"the host)", flush=True)
    print(f"[render] eval vs the flat f32 render per view (max |diff|, mean "
          f"|diff|, live gaussians, footprints above ksmall, above kmid, "
          f"eval capacities that bind): {diffs}; {gated} of {N_VIEWS} views "
          f"gated at max {PACK8_MAX}, mean {PACK8_MEAN}", flush=True)
    if gated == 0:
        fail("no view of the render path could be held to the f32 render")


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
    # K1: the gt renders and one forward per iteration; K2: one backward
    # per iteration; K3: the untrained and the final evaluate
    want = {"blend_fwd": n_views + TRAIN_ITERS, "blend_bwd": TRAIN_ITERS,
            "blend_eval_packed": 2 * n_views, "blend_eval": 0}
    # K5: each step's prefilter, and the renders outside the steps
    if blend_launches(launches) != want \
            or launches["preprocess"] < TRAIN_ITERS:
        fail(f"launches {launches}, expected {want} and K5 at least once "
             f"an iteration")
    return launches


def profile_layers(t, n: int) -> dict:
    """The step's layers over n iterations by torch.profiler: the host time
    of the train_step.* spans (a densify adjust's left out), and the device
    time of the kernels launched inside each (autograd launches the
    backward's from its own thread, so launches are matched to ranges by
    time); against the median unprofiled step of n more iterations (CUDA
    events)."""
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
                    and e.name.startswith("train_step.")
                    and e.name != "train_step.densify")
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
            if not k.name.startswith(SPAN_PREFIXES):
                device[name] += k.duration / 1e3 / n
                by_kernel[k.name] = by_kernel.get(k.name, 0.0) \
                    + k.duration / 1e3 / n
    # every device event once, as a check on the attribution above
    device_events = [e for e in events if e.device_type == DeviceType.CUDA
                     and not e.name.startswith(SPAN_PREFIXES)
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

    kernels = hold_training_kernels(
        captured, t.raster_config, "the trained 256x256 map", "trained")
    kernels["blend_eval_packed"] = trained_eval(t)
    return kernels


def hold_training_kernels(captured, rc, where: str, tag: str) -> dict:
    """K1 and K2 against their plain versions on the training steps whose
    blend_backward arguments are `captured` (at the gates of phase 3): with
    the loss's own cotangents, with seeded ones, and with the opacities
    above 0.5 raised to 1 so that alpha meets the 0.99 clamp. Returns their
    numbers for the kernels line (per call, averaged over the steps)."""
    import segs_slam_tpu_torch.ops.rasterizer.blend as blend
    from segs_slam_tpu_torch.utils.kernel_timing import tile_counts

    n_steps = len(captured)
    g = torch.Generator().manual_seed(SEED + 4)
    equal = dict.fromkeys(("own", "raised"), 0)
    pixels = 0
    worst = dict.fromkeys(("own", "seeded", "clamped"), 0.0)
    k1_err = k2_err = 0.0
    n_clamped = {"own": 0, "raised": 0}
    sums = dict.fromkeys(("k1_call_ms", "k1_plain_ms", "k2_call_ms",
                          "k2_plain_ms"), 0.0)
    walked = {"k1": 0, "k2": 0}
    # (bytes, operations) of all the steps together: the bound of a mean
    # call is taken on these, so that it has one side
    work = {"k1": np.zeros(2), "k2": np.zeros(2)}
    with torch.inference_mode():
        for args in captured:
            fargs, (dcolor, ddepth, dfinal_t, final_t, ncontrib) = (
                args[:6], args[6:])
            fwd = check_forward(fargs)
            if not fwd["ok"]:
                fail(f"K1 disagrees with its plain version on a step of "
                     f"{where}: {fwd['err']}")
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
                    fail(f"K2 disagrees with its plain version on a step of "
                         f"{where} ({name} cotangents): {res['row_err']}")
                worst[name] = max(worst[name], max(res["row_err"]))
            if not rfwd["ok"]:
                fail(f"K1 disagrees with its plain version with raised "
                     f"opacities: {rfwd['err']}")
            k2_err = max(k2_err, own["max_abs_err"])
            tx = fargs[4]
            pairs = pair_counts(*fargs[:3], ncontrib, tx, rc)
            n_clamped["own"] += pairs["clamped"]
            n_clamped["raised"] += pair_counts(
                *rargs[:3], rfwd["out"][3], tx, rc)["clamped"]
            works, walked_k2 = blend_work(
                fargs[1], fargs[2], ncontrib, fargs[0].shape[1], pairs)
            for k, w in zip(("k1", "k2"), works):
                work[k] += w
            walked["k1"] += pairs["fwd_walked"]
            walked["k2"] += walked_k2
            sums["k1_call_ms"] += cuda_ms(
                lambda: blend.blend_forward_cuda(*fargs), reps=5, warmup=1)
            sums["k1_plain_ms"] += cuda_ms(
                lambda: blend.blend_forward_reference(*fargs), reps=1,
                warmup=1)
            sums["k2_call_ms"] += cuda_ms(
                lambda: blend.blend_backward_cuda(*args), reps=5, warmup=1)
            sums["k2_plain_ms"] += cuda_ms(
                lambda: blend.blend_backward_reference(*args), reps=1,
                warmup=1)
        mean = {k: v / n_steps for k, v in sums.items()}
        mean["k1_ms"] = kernel_ms(
            [lambda a=a: blend.blend_forward_cuda(*a[:6]) for a in captured],
            KERNEL_FUNCS["blend_fwd"])
        mean["k2_ms"] = kernel_ms(
            [lambda a=a: blend.blend_backward_cuda(*a) for a in captured],
            KERNEL_FUNCS["blend_bwd"])
    tiles = tile_counts(torch.cat([a[1] for a in captured]),
                        torch.cat([a[2] for a in captured]))
    bounds = {k: bound(w, n_steps) for k, w in work.items()}
    for k, b in bounds.items():
        mean[f"{k}_bound_ms"] = b["bound_ms"]
    agree = {k: v / pixels for k, v in equal.items()}
    print(f"[{tag}] K1 and K2 on {n_steps} steps of {where} "
          f"(NK {captured[0][0].shape[1]}): n_contrib equal on "
          f"{agree['own'] * 100:.4f} % of pixels ({agree['raised'] * 100:.4f}"
          f" % with the opacities raised); worst K2 row error / row max: own "
          f"cotangents {worst['own']:.2e}, seeded {worst['seeded']:.2e}, "
          f"opacities raised {worst['clamped']:.2e}; taken pairs with op G "
          f"above the clamp: {n_clamped['own']} as trained, "
          f"{n_clamped['raised']} raised", flush=True)
    per_call = {k: (w / n_steps).tolist() for k, w in work.items()}
    print(f"[{tag}] per call, mean of {n_steps} (k*_ms: device, "
          f"profiler, {DEVICE_REPS}+ launches on each; k*_call_ms: CUDA "
          f"events): {json.dumps({k: round(v, 4) for k, v in mean.items()})}"
          f"; bound by {({k: b['bound_by'] for k, b in bounds.items()})}; "
          f"(bytes, operations) a call {per_call}; instances a tile: mean "
          f"{tiles['mean']:.1f}, p99 {tiles['p99']:.1f}, max {tiles['max']}; "
          f"a step: {tiles['total'] / n_steps:.1f} instances, walked "
          f"by K1 {walked['k1'] / n_steps:.1f}, by K2 "
          f"{walked['k2'] / n_steps:.1f}", flush=True)
    if min(agree.values()) < 0.9999:
        fail(f"n_contrib equal on only {agree} of the pixels of {where}")
    if n_clamped["raised"] == 0:
        fail(f"raising the opacities put no pair above the alpha clamp on "
             f"{where}")
    ppt = pixels_per_thread(captured[0][1])
    return {
        "blend_fwd": {"max_abs_err": k1_err, "ms": mean["k1_ms"],
                      "call_ms": mean["k1_call_ms"],
                      "plain_ms": mean["k1_plain_ms"],
                      "bound_ms": mean["k1_bound_ms"],
                      "bound_by": bounds["k1"]["bound_by"],
                      "library_ms": None, "pixels_per_thread": ppt},
        "blend_bwd": {"max_abs_err": k2_err, "ms": mean["k2_ms"],
                      "call_ms": mean["k2_call_ms"],
                      "plain_ms": mean["k2_plain_ms"],
                      "bound_ms": mean["k2_bound_ms"],
                      "bound_by": bounds["k2"]["bound_by"],
                      "library_ms": None, "pixels_per_thread": ppt},
    }


def trained_eval(t) -> dict:
    """The trained Trainer's evaluate (K3 once per keyframe, K1 never), K3
    against its plain version on the keyframes' own inputs, as trained and
    with the opacities above 0.5 raised to 1, and record_all_keyframes'
    files read back by the harness. Returns K3's numbers for the kernels
    line (per call, mean over the keyframes)."""
    import segs_slam_tpu_torch.ops.rasterizer.blend as blend
    from segs_slam_tpu_torch.eval import harness
    from segs_slam_tpu_torch.eval.recorder import record_all_keyframes
    from segs_slam_tpu_torch.utils.kernel_timing import tile_counts

    captured = []
    packed = blend.blend_forward_eval_packed

    def recording(*args):
        captured.append(args)
        return packed(*args)

    t.reset_eval_renderer()  # calibrated on the trained map
    blend.blend_forward_eval_packed = recording
    reset_launches()
    try:
        m = t.evaluate()
        torch.cuda.synchronize()
    finally:
        blend.blend_forward_eval_packed = packed
    launches = read_launches()
    n_kf = m["n_keyframes"]
    want = dict.fromkeys(KERNELS, 0)
    want["blend_eval_packed"] = n_kf
    rc = t.eval_renderer().raster_config
    print(f"[trained] evaluate: PSNR {m['psnr']:.3f} dB, SSIM "
          f"{m['ssim']:.4f} over {n_kf} keyframes; launches {launches}; "
          f"eval config ksmall {rc.ksmall} kmid {rc.kmid} nmid {rc.nmid} "
          f"nlarge {rc.nlarge} compact {rc.compact} pack8 {rc.pack8}",
          flush=True)
    # K5: twice a keyframe, and on the calibration's views
    if blend_launches(launches) != blend_launches(want) \
            or launches["preprocess"] < 2 * n_kf or len(captured) != n_kf:
        fail(f"evaluate launched {launches}, expected {want} and K5 at "
             f"least twice a keyframe")

    sums = dict.fromkeys(("call_ms", "plain_ms"), 0.0)
    work = np.zeros(2)
    walked = 0
    err = {"own": 0.0, "raised": 0.0}
    tested, clamped = [], 0
    with torch.inference_mode():
        for args in captured:
            own = check_eval("blend_eval_packed", args)
            raised = check_eval("blend_eval_packed",
                                (raise_opacity(args[0], args[5]), *args[1:]))
            for name, res in (("own", own), ("raised", raised)):
                if not res["ok"]:
                    fail(f"K3 disagrees with its plain version on a trained "
                         f"keyframe ({name}): max |err| {res['max_abs_err']}")
                err[name] = max(err[name], res["max_abs_err"])
            clamped += raised["pairs"]["clamped"]
            tested.append(own["tested_share"])
            work += own["work"]
            walked += own["pairs"]["fwd_walked"]
            sums["call_ms"] += cuda_ms(
                lambda: blend.blend_forward_eval_packed_cuda(*args), reps=5,
                warmup=1)
            sums["plain_ms"] += cuda_ms(
                lambda: blend.blend_forward_eval_packed_reference(*args),
                reps=1, warmup=1)
        mean = {k: v / n_kf for k, v in sums.items()}
        mean["ms"] = kernel_ms(
            [lambda a=a: blend.blend_forward_eval_packed_cuda(*a)
             for a in captured], KERNEL_FUNCS["blend_eval_packed"])
    b = bound(work, n_kf)
    tiles = tile_counts(torch.cat([a[1] for a in captured]),
                        torch.cat([a[2] for a in captured]))
    print(f"[trained] K3 on the {n_kf} keyframes' own inputs (256x256, NK "
          f"{captured[0][0].shape[1]}): max |err| {err['own']:.3g}, with the "
          f"opacities raised {err['raised']:.3g} ({clamped} taken pairs "
          f"above the clamp); per call: device {mean['ms']:.4f} ms "
          f"(profiler, {DEVICE_REPS}+ launches on each), call "
          f"{mean['call_ms']:.4f} ms, plain {mean['plain_ms']:.3f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}), (bytes, operations) a "
          f"call {(work / n_kf).tolist()}; instances a tile: mean "
          f"{tiles['mean']:.1f}, p99 {tiles['p99']:.1f}, max {tiles['max']}; "
          f"a keyframe: {tiles['total'] / n_kf:.1f} instances, walked "
          f"{walked / n_kf:.1f}; the latch leaves "
          f"{100 * float(np.mean(tested)):.2f} % of the pairs in range to "
          f"test", flush=True)
    if clamped == 0:
        fail("raising the opacities put no K3 pair above the alpha clamp")

    out = WORK / "record"
    res = record_all_keyframes(t, out)
    run = harness.evaluate_run(out)
    times = np.loadtxt(out / "render_time.txt")
    peak = out / "DevicePeakUsageMB.txt"
    if not peak.is_file():
        fail(f"record_all_keyframes wrote no {peak.name} on the card")
    print(f"[trained] record_all_keyframes: {len(times)} keyframes, "
          f"render_time {float(times.mean()):.3f} ms "
          f"(per dispatch {float(np.loadtxt(out / 'render_time_per_dispatch.txt').mean()):.3f}"
          f" ms), render_fps {res['render_fps']:.1f}, harness render_fps "
          f"{run.get('render_fps', float('nan')):.1f}, PSNR {run['psnr']:.3f}; "
          f"device peak {float(np.loadtxt(peak)):.1f} MB",
          flush=True)
    if len(times) != n_kf or not np.isfinite(run.get("render_fps", np.nan)):
        fail(f"the harness read no finite render_fps from {out}")
    return {"max_abs_err": err["own"], "ms": mean["ms"],
            "call_ms": mean["call_ms"],
            "plain_ms": mean["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "library_ms": None,
            "pixels_per_thread": pixels_per_thread(captured[0][1], True)}


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
    """The whole render, one train step and the eval render of a small map
    on the card against the CPU path."""
    from segs_slam_tpu_torch.core import Camera, Keyframe
    from segs_slam_tpu_torch.io.convert import (
        anchors_from_numpy,
        decoders_from_jax,
        flatten_params,
    )
    from segs_slam_tpu_torch.models.config import ModelConfig
    from segs_slam_tpu_torch.models.renderer import EvalRenderer, render
    from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
    from segs_slam_tpu_torch.train.config import OptimizationConfig
    from segs_slam_tpu_torch.train.optimizer import leaves
    from segs_slam_tpu_torch.train.step import (
        init_train_state,
        make_train_step,
    )
    from segs_slam_tpu_torch.utils.synthetic import seeded_map

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
    images, steps, evals = [], [], []
    for d in ("cpu", dev):
        cam_d = {k: torch.as_tensor(v, device=d)
                 for k, v in kf.render_inputs().items()}
        bg = torch.tensor([0.1, 0.2, 0.3], device=d)
        with torch.inference_mode():
            images.append(render(
                anchors_from_numpy(anchors_np, d),
                decoders_from_jax(flatten_params(dec_np), d), cam_d, w, h,
                bg, mc, rc))
        evals.append(EvalRenderer(
            mc, rc.eval_variant(w, h), w, h, bg, device=d).render_with_counts(
                anchors_from_numpy(anchors_np, d),
                decoders_from_jax(flatten_params(dec_np), d), cam_d))
        ts = init_train_state(anchors_from_numpy(anchors_np, d),
                              decoders_from_jax(flatten_params(dec_np), d),
                              mc)
        ts, m = make_train_step(mc, oc, rc, w, h)(
            ts, cam_d, torch.as_tensor(gt, device=d), bg)
        # the first step's moments are (1 - b1) g: the step's gradients
        # (the state has no pose rows: their leaf is empty)
        steps.append((float(m["loss"]), {
            p: (x / 0.1).cpu() for p, x in leaves(ts.adam.mu) if x.numel()}))
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

    cpu, gpu = evals
    err = float((gpu["image"].cpu() - cpu["image"]).abs().max())
    print(f"[small] 96x64 eval render (EvalRenderer, K3 pack8), card vs CPU "
          f"path: max |image err| {err:.3g}, num_instances "
          f"{int(gpu['num_instances'])}/{int(cpu['num_instances'])}",
          flush=True)
    if err > 2e-4 or int(gpu["num_instances"]) != int(cpu["num_instances"]):
        fail("the card's eval render disagrees with the CPU path")
    if float(cpu["image"].max() - cpu["image"].min()) < 0.05:
        fail("the small-input eval render is blank")

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


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class SlamProbe:
    """What one slam_rgbd run does, seen by wrapping the Trainer's methods
    and the blend's backward dispatcher for the run's duration (the wrappers
    count and keep references; they add no device work): the iterations'
    losses (device tensors, read after the run), the image size each
    iteration trained at (its pyramid level), densification adjusts, pose
    refinement gains, a torch.profiler window of window[1] iterations from
    iteration window[0] (device time against the window's host clock), and
    K2's arguments on capture[1] steps from iteration capture[0]."""

    def __init__(self, dev, window=None, capture=None):
        self.dev, self.window, self.capture = dev, window, capture
        self.losses, self.gains, self.captured = [], [], []
        self.k5_per_iter: list = []  # K5 launches in each iteration trained
        self.sizes: dict = {}
        self.adjusts = 0
        self.window_stats = None
        self._profile = None
        self._capturing = False

    def __enter__(self):
        import segs_slam_tpu_torch.ops.rasterizer.blend as blend
        import segs_slam_tpu_torch.train.trainer as tr

        probe, cls = self, tr.Trainer
        self._saved = (cls.train_iteration, cls._step_for,
                       cls.refine_keyframe_pose, tr.make_adjust_anchor,
                       blend.blend_backward)
        iterate, step_for, refine, make_adjust, backward = self._saved

        def train_iteration(trainer):
            it = trainer.iteration + 1
            if probe.window and it == probe.window[0]:
                probe._start_window()
            probe._capturing = bool(probe.capture) and (
                probe.capture[0] <= it < sum(probe.capture))
            k5 = launch_counters()["preprocess"]
            before = k5.launches
            m = iterate(trainer)
            probe._capturing = False
            if m is not None:
                probe.losses.append(m["loss"])
                probe.k5_per_iter.append(k5.launches - before)
            if probe.window and it == sum(probe.window) - 1:
                probe._stop_window()
            return m

        def step_for_size(trainer, w, h):
            probe.sizes[(w, h)] = probe.sizes.get((w, h), 0) + 1
            return step_for(trainer, w, h)

        def refine_keyframe_pose(trainer, kf, *args, **kw):
            gain = refine(trainer, kf, *args, **kw)
            probe.gains.append(gain)
            return gain

        def make_adjust_anchor(*args):
            adjust = make_adjust(*args)

            def counted(*a):
                probe.adjusts += 1
                return adjust(*a)
            return counted

        def blend_backward(*args):
            if probe._capturing:
                probe.captured.append(args)
            return backward(*args)

        cls.train_iteration, cls._step_for = train_iteration, step_for_size
        cls.refine_keyframe_pose = refine_keyframe_pose
        tr.make_adjust_anchor = make_adjust_anchor
        blend.blend_backward = blend_backward
        return self

    def __exit__(self, *exc):
        import segs_slam_tpu_torch.ops.rasterizer.blend as blend
        import segs_slam_tpu_torch.train.trainer as tr

        cls = tr.Trainer
        (cls.train_iteration, cls._step_for, cls.refine_keyframe_pose,
         tr.make_adjust_anchor, blend.blend_backward) = self._saved
        if self._profile is not None:
            self._profile.__exit__(None, None, None)
            self._profile = None

    def _start_window(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        _sync(self.dev)
        self._profile = profile(activities=acts)
        self._profile.__enter__()
        self._t0 = time.perf_counter()

    def _stop_window(self):
        from torch.autograd import DeviceType

        _sync(self.dev)
        wall_ms = (time.perf_counter() - self._t0) * 1e3
        self._profile.__exit__(None, None, None)
        events = [e for e in self._profile.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(SPAN_PREFIXES)
                  and not getattr(e, "is_user_annotation", False)]
        self._profile = None
        n = self.window[1]
        device_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
        self.window_stats = {"host_ms": wall_ms / n,
                             "device_ms": device_ms / n,
                             "device_events": len(events) / n,
                             "busy": device_ms / wall_ms}


def make_slam_sequence(dev) -> Path:
    """The port's make_rgbd_dataset at its defaults (640x480, fx = fy =
    576, 8,000 gaussians, seed 0), frames cut from 200 to SLAM_FRAMES."""
    from segs_slam_tpu_torch.utils import make_rgbd_dataset

    seq = WORK / "slam_seq"
    t0 = time.perf_counter()
    make_rgbd_dataset.main(["--out", str(seq), "--frames", str(SLAM_FRAMES),
                            "--device", dev.type])
    print(f"[slam] sequence: {SLAM_FRAMES} frames at 640x480 by "
          f"make_rgbd_dataset in {time.perf_counter() - t0:.1f} s (set-up, "
          f"outside every number below)", flush=True)
    return seq


def slam_argv(seq: Path, out: Path, budget: int, dev) -> list:
    return ["--dataset", "replica", "--path", str(seq), "--out", str(out),
            "--tracker", "oracle", "--width", "640", "--height", "480",
            "--fx", "576", "--fy", "576", "--cx", "320", "--cy", "240",
            "--iters-budget", str(budget), "--device", dev.type]


def png_l1(out: Path) -> float:
    """Mean |rendered - ground truth| over record_all_keyframes' PNGs."""
    from PIL import Image

    errs = []
    for r in sorted((out / "rendered").glob("*.png")):
        a = np.asarray(Image.open(r), np.float32) / 255.0
        b = np.asarray(Image.open(out / "ground_truth" / r.name),
                       np.float32) / 255.0
        errs.append(float(np.abs(a - b).mean()))
    return float(np.mean(errs)) if errs else float("nan")


def finite_losses(probe, label: str) -> np.ndarray:
    losses = torch.stack(probe.losses).cpu().numpy() if probe.losses \
        else np.zeros(0)
    if not len(losses) or not np.isfinite(losses).all():
        fail(f"{label}: {len(losses)} losses, finite: "
             f"{bool(np.isfinite(losses).all())}")
    return losses


def slam_run_a(seq: Path, dev) -> dict:
    """Run A, the measured path: slam_rgbd at the app's defaults with the
    pose oracle and SLAM_ITERS iterations."""
    import segs_slam_tpu_torch.ops.rasterizer.blend as blend
    from segs_slam_tpu_torch.apps import slam_rgbd
    from segs_slam_tpu_torch.eval import harness

    out = WORK / "slam_a"
    for k in blend.train_binnings:
        blend.train_binnings[k] = 0
    reset_launches()
    with SlamProbe(dev, window=SLAM_WINDOW, capture=SLAM_CHECKED) as probe:
        res = slam_rgbd.main(slam_argv(seq, out, SLAM_ITERS, dev))
    launches = read_launches()
    binnings = dict(blend.train_binnings)
    t = res["trainer"]
    losses = finite_losses(probe, "run A")
    run = harness.evaluate_run(out)
    l1 = png_l1(out)
    n_kf = len(t.scene.keyframes)
    w = probe.window_stats or {}
    ms = res["ms_per_iter"]
    binning = ("packed" if binnings["packed"] and not binnings["f32"]
               else "f32" if not binnings["packed"] else "mixed")
    print(f"[slam] run A: slam_rgbd --tracker oracle, {SLAM_FRAMES} frames "
          f"at 640x480, {n_kf} keyframes, {res['iterations']} iterations: "
          f"mapping {ms:.3f} ms/iter, {1000.0 / ms:.2f} iters/s (host clock "
          f"around Mapper.run to a synchronised device, "
          f"{res['mapping_s']:.1f} s); profiler window of {SLAM_WINDOW[1]} "
          f"mapper iterations from {SLAM_WINDOW[0]}: host "
          f"{w.get('host_ms', float('nan')):.3f} ms/iter, device "
          f"{w.get('device_ms', float('nan')):.4f} ms/iter, "
          f"{w.get('device_events', float('nan')):.0f} device events an "
          f"iteration, device busy {100 * w.get('busy', float('nan')):.1f} "
          f"% of the window ({100 * w.get('device_ms', float('nan')) / ms:.1f}"
          f" % of an unprofiled iteration); launches {launches}; training "
          f"binning {binning} ({binnings}); active anchors "
          f"{int(t.state.anchors.num_active())}; densify adjusts "
          f"{probe.adjusts}; loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"record_all_keyframes read back by the harness: PSNR "
          f"{run.get('psnr', float('nan')):.3f} dB, SSIM "
          f"{1.0 - run.get('dssim', float('nan')):.4f}, L1 {l1:.5f}, render "
          f"{run.get('render_fps', float('nan')):.1f} FPS; ATE RMSE "
          f"{run.get('ate_rmse', float('nan')):.3e} m", flush=True)
    if res["iterations"] != SLAM_ITERS:
        fail(f"run A trained {res['iterations']} iterations, not "
             f"{SLAM_ITERS}")
    if binning != "packed":
        fail(f"run A's steps did not all take the packed training binning: "
             f"{binnings}")
    if probe.adjusts != 2:
        fail(f"run A densified {probe.adjusts} times, expected 2")
    if not (launches["blend_fwd"] >= SLAM_ITERS
            and launches["blend_bwd"] == SLAM_ITERS
            and launches["blend_eval_packed"] >= n_kf):
        fail(f"run A launched {launches}")
    # K5: the prefilter of each step (its projection asks for gradients)
    k5 = sorted(set(probe.k5_per_iter))
    print(f"[slam] run A: K5 launches an iteration {k5} over "
          f"{len(probe.k5_per_iter)} iterations", flush=True)
    if k5 != [1] or len(probe.k5_per_iter) != SLAM_ITERS:
        fail(f"run A's iterations launched K5 {k5} times each")
    if not run.get("ate_rmse", np.inf) <= 1e-3:
        fail(f"run A's ATE {run.get('ate_rmse')} m is above 1e-3 m")
    if not all(np.isfinite(run.get(k, np.nan))
               for k in ("psnr", "dssim", "render_fps")) \
            or not np.isfinite(l1):
        fail(f"run A's recorded metrics are not finite: {run}, L1 {l1}")
    if len(probe.captured) != SLAM_CHECKED[1]:
        fail(f"{len(probe.captured)} blend backwards captured, expected "
             f"{SLAM_CHECKED[1]}")
    if w.get("device_ms", 0.0) <= 0.0:
        fail("the profiler window saw no device time in run A")
    return {"trainer": t, "launches": launches, "probe": probe,
            "ms_per_iter": ms}


def slam_binning_cost(t, n: int = 10) -> None:
    """The packed training binning against the f32 one on the card: the
    binning alone on one keyframe's view of run A's map (CUDA events,
    median of n), and n train iterations with each (the step rebuilt)."""
    from segs_slam_tpu_torch.models.renderer import project_view
    from segs_slam_tpu_torch.ops.rasterizer import binning

    rc = t.raster_config
    kf = sorted(t.scene.keyframes.items())[len(t.scene.keyframes) // 2][1]
    cam = t._kf_inputs(kf)[0]
    with torch.no_grad():
        *_, feats, aux = project_view(t.state.anchors, t.state.decoders,
                                      cam, t.width, t.height, t.model_config,
                                      rc)
        tx, ty = rc.grid(t.width, t.height)
        packed = cuda_ms(lambda: binning.expand_and_sort_packed_train(
            binning.compact_gaussians_packed(feats, aux, rc, with_orig=True),
            tx, ty, rc), reps=n)
        f32 = cuda_ms(lambda: binning.expand_and_sort(
            binning.compact_gaussians(feats, aux, rc), tx, ty, rc), reps=n)
    steps = {}
    for name, cfg in (("packed", rc),
                      ("f32", dataclasses.replace(rc, packed_train=False)),
                      ("packed again", rc)):
        t.raster_config = cfg
        t._build_step()
        steps[name] = float(np.median([
            cuda_ms(t.train_iteration, reps=1, warmup=0) for _ in range(n)]))
    print(f"[slam] training binning on run A's map at 640x480 (CUDA events,"
          f" median of {n}): packed {packed:.3f} ms, f32 {f32:.3f} ms; a "
          f"train iteration with each: " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in steps.items()), flush=True)


def _perturbed(kf, ang_deg=1.0, dt=(0.02, -0.015, 0.01)):
    """kf's pose rotated by ang_deg about the view axis and shifted by dt
    (tests/test_pose_refine.py's perturbation)."""
    from segs_slam_tpu_torch.core import se3

    ang = np.deg2rad(ang_deg)
    dR = np.array([[np.cos(ang), -np.sin(ang), 0],
                   [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    Rn = dR @ kf.rotation_matrix()
    qn = se3.rotmat_to_quat(torch.as_tensor(Rn, dtype=torch.float32))
    return qn.numpy(), dR @ kf.trans + np.asarray(dt)


def _pose_error(kf, R0, t0):
    """(rotation error in degrees, camera-centre error in m) against the
    true world-to-camera (R0, t0)."""
    R = kf.rotation_matrix()
    cos = np.clip((np.trace(R @ R0.T) - 1.0) / 2.0, -1.0, 1.0)
    return (float(np.degrees(np.arccos(cos))),
            float(np.linalg.norm(-R.T @ kf.trans + R0.T @ t0)))


def slam_pose_refine(t) -> None:
    """refine_keyframe_pose on the card: one of run A's keyframes perturbed
    by 1 degree and about 2 cm, then 8 full-resolution steps (pool 1)."""
    kf = sorted(t.scene.keyframes.items())[len(t.scene.keyframes) // 2][1]
    R0, t0 = kf.rotation_matrix(), np.asarray(kf.trans).copy()
    t.set_keyframe_pose(kf, *_perturbed(kf))
    before = _pose_error(kf, R0, t0)
    t_ms = time.perf_counter()
    gain = t.refine_keyframe_pose(kf, steps=8, pool=1)
    t_ms = (time.perf_counter() - t_ms) * 1e3
    after = _pose_error(kf, R0, t0)
    print(f"[slam] pose refinement on the card, keyframe {kf.kf_id} of run "
          f"A perturbed by 1 deg and 2.7 cm: error {before[0]:.4f} deg / "
          f"{before[1] * 100:.3f} cm -> {after[0]:.4f} deg / "
          f"{after[1] * 100:.3f} cm in 8 steps at pool 1 ({t_ms:.1f} ms, "
          f"loss gain {gain:.6f})", flush=True)
    if not (after[1] < before[1] and after[0] <= before[0]):
        fail(f"pose refinement did not reduce the pose error: {before} -> "
             f"{after}")


def slam_run_b(seq: Path, dev) -> dict:
    """Run B, the pose and pyramid paths: pose rows, refinement on arrival,
    every 25 iterations and at shutdown, and two pyramid sub-levels from a
    reference-style YAML, at SLAM_B_ITERS iterations."""
    from segs_slam_tpu_torch.apps import slam_rgbd
    from segs_slam_tpu_torch.eval import harness

    yaml = WORK / "pyramid.yaml"
    yaml.write_text(PYRAMID_YAML)
    out = WORK / "slam_b"
    argv = slam_argv(seq, out, SLAM_B_ITERS, dev) + [
        "--optimize-poses", "on", "--pose-refine-on-arrival", "2",
        "--pose-refine-every", "25", "--shutdown-pose-refine", "1",
        "--shutdown-pose-refine-iters", "20", "--mapper-yaml", str(yaml)]
    reset_launches()
    with SlamProbe(dev) as probe:
        res = slam_rgbd.main(argv)
    launches = read_launches()
    losses = finite_losses(probe, "run B")
    run = harness.evaluate_run(out)
    sizes = sorted(probe.sizes.items())
    gains = np.asarray(probe.gains)
    print(f"[slam] run B: --optimize-poses on, refinement on arrival (2 "
          f"steps), every 25 and at shutdown (1 round, 20 re-fit "
          f"iterations), GausPyramid 2 sub-levels: {res['iterations']} "
          f"iterations, {res['ms_per_iter']:.3f} ms/iter; iterations by "
          f"image size {sizes}; pose rows folded at shutdown "
          f"{res['folded']}; {len(gains)} refinements, loss gains min "
          f"{gains.min() if len(gains) else float('nan'):.6f} mean "
          f"{gains.mean() if len(gains) else float('nan'):.6f}; loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}; launches {launches}; PSNR "
          f"{run.get('psnr', float('nan')):.3f} dB, ATE RMSE "
          f"{run.get('ate_rmse', float('nan')):.3e} m", flush=True)
    if len(sizes) != 3:
        fail(f"run B trained at image sizes {sizes}, not three levels")
    if not len(gains) or not (np.isfinite(gains).all()
                              and (gains >= 0.0).all()):
        fail(f"run B's pose refinement gains: {gains}")
    if res["folded"] <= 0:
        fail("run B folded no pose rows at shutdown")
    return {"launches": launches}


def phase_slam(dev) -> dict:
    """Phase 9: the online RGB-D mapping path (see the module docstring)."""
    seq = make_slam_sequence(dev)
    a = slam_run_a(seq, dev)
    kernels = hold_training_kernels(
        a["probe"].captured, a["trainer"].raster_config,
        "run A's packed-binning steps at 640x480", "slam")
    slam_binning_cost(a["trainer"])
    slam_pose_refine(a["trainer"])
    b = slam_run_b(seq, dev)
    return {"kernels": kernels, "launches": a["launches"],
            "launches_b": b["launches"]}


def _tensors_equal(a, b) -> bool:
    """Two trees of dataclasses, modules, dicts and sequences equal, leaf
    by leaf."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, torch.nn.Module):
        return _tensors_equal(a.state_dict(), b.state_dict())
    if dataclasses.is_dataclass(a):
        return all(_tensors_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(
            _tensors_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_tensors_equal, a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def colmap_run(dev) -> dict:
    """Phase 10c: the offline train_colmap app on its maker's scene at both
    defaults (48 views at 640x480, 8,000 gaussians, 12,000 sparse points;
    capacity 2^16, compact 2^16, kmax 8, ksmall 4, nlarge 2^13, the f32
    training binning) for COLMAP_ITERS iterations, with --out."""
    import segs_slam_tpu_torch.ops.rasterizer.blend as blend
    import segs_slam_tpu_torch.train.trainer as tr
    from segs_slam_tpu_torch.apps import train_colmap
    from segs_slam_tpu_torch.io.checkpoint import load_train_state
    from segs_slam_tpu_torch.utils import make_colmap_dataset

    scene, out = WORK / "colmap_scene", WORK / "colmap_out"
    t0 = time.perf_counter()
    make_colmap_dataset.main(["--out", str(scene), "--device", dev.type])
    print(f"[colmap] scene by make_colmap_dataset in "
          f"{time.perf_counter() - t0:.1f} s (set-up)", flush=True)
    # the untrained map's evaluation, taken after initialize_map and so
    # outside the app's training clock; its launches are this script's own
    # work, read apart and taken off the app's
    before, own = {}, {}
    init = tr.Trainer.initialize_map

    def initialize_then_evaluate(trainer, *args, **kw):
        n = init(trainer, *args, **kw)
        at = read_launches()
        before.update(trainer.evaluate())
        trainer.reset_eval_renderer()
        _sync(trainer.device)
        own.update({k: v - at[k] for k, v in read_launches().items()})
        return n

    for k in blend.train_binnings:
        blend.train_binnings[k] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    tr.Trainer.initialize_map = initialize_then_evaluate
    try:
        with SlamProbe(dev, capture=COLMAP_CHECKED) as probe:
            res = train_colmap.main(["--scene", str(scene), "--iters",
                                     str(COLMAP_ITERS), "--out", str(out),
                                     "--device", dev.type])
    finally:
        tr.Trainer.initialize_map = init
    launches = {k: v - own[k] for k, v in read_launches().items()}
    binnings = dict(blend.train_binnings)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    t = res["trainer"]
    losses = finite_losses(probe, "train_colmap")
    back = load_train_state(out / "ckpt", device=dev)
    same = back.step == t.state.step and _tensors_equal(back, t.state)
    gain = res["psnr"] - before.get("psnr", float("nan"))
    print(f"[colmap] train_colmap, {res['n_keyframes']} views at 640x480, "
          f"{res['iterations']} iterations: {res['ms_per_iter']:.3f} ms/iter "
          f"({1000.0 / res['ms_per_iter']:.2f} iters/s, host clock around "
          f"Trainer.train to a synchronised device); evaluate() PSNR "
          f"{before.get('psnr', float('nan')):.3f} -> {res['psnr']:.3f} dB "
          f"(+{gain:.3f}), SSIM {before.get('ssim', float('nan')):.4f} -> "
          f"{res['ssim']:.4f}; active anchors "
          f"{int(t.state.anchors.num_active())} after {probe.adjusts} "
          f"densify adjusts; training binnings {binnings}; launches "
          f"{launches} (the untrained map's evaluation apart: {own}); loss {losses[0]:.5f} -> {losses[-1]:.5f}; peak "
          f"device memory {peak_gib:.2f} GiB; --out train state reloads "
          f"equal: {same}", flush=True)
    if res["iterations"] != COLMAP_ITERS:
        fail(f"train_colmap trained {res['iterations']} iterations")
    if binnings["f32"] != COLMAP_ITERS or binnings["packed"]:
        fail(f"train_colmap's steps did not all take the f32 training "
             f"binning: {binnings}")
    if launches["blend_bwd"] != COLMAP_ITERS \
            or launches["blend_fwd"] < COLMAP_ITERS \
            or launches["blend_eval_packed"] != res["n_keyframes"]:
        fail(f"train_colmap launched {launches}")
    if probe.adjusts != 2:
        fail(f"train_colmap densified {probe.adjusts} times, expected 2")
    if not gain >= 3.0:
        fail(f"train_colmap gained {gain} dB of PSNR, below 3 dB")
    if not same:
        fail("the train state train_colmap wrote to --out reloads "
             "different")
    if len(probe.captured) != COLMAP_CHECKED[1]:
        fail(f"{len(probe.captured)} blend backwards captured in "
             f"train_colmap, expected {COLMAP_CHECKED[1]}")
    kernels = hold_training_kernels(
        probe.captured, t.raster_config,
        "train_colmap's f32-binning steps at 640x480", "colmap")
    return {"launches": launches, "kernels": kernels}


def stereo_run(dev) -> dict:
    """Phase 10d: slam_stereo --pre-rectified --tracker oracle on its
    maker's sequence at both defaults (120 pairs at 640x480, baseline 0.11;
    kmax 16, the packed training binning) for STEREO_ITERS iterations."""
    import segs_slam_tpu_torch.ops.rasterizer.blend as blend
    from segs_slam_tpu_torch.apps import slam_stereo
    from segs_slam_tpu_torch.core import se3
    from segs_slam_tpu_torch.core.camera import Camera
    from segs_slam_tpu_torch.eval import harness, metrics
    from segs_slam_tpu_torch.io import datasets
    from segs_slam_tpu_torch.utils import make_stereo_dataset

    seq, out = WORK / "stereo_seq", WORK / "stereo_out"
    t0 = time.perf_counter()
    make_stereo_dataset.main(["--out", str(seq), "--device", dev.type])
    print(f"[stereo] sequence by make_stereo_dataset in "
          f"{time.perf_counter() - t0:.1f} s (set-up)", flush=True)
    for k in blend.train_binnings:
        blend.train_binnings[k] = 0
    reset_launches()
    with SlamProbe(dev, capture=STEREO_CHECKED) as probe:
        res = slam_stereo.main(["--path", str(seq), "--out", str(out),
                                "--pre-rectified", "--tracker", "oracle",
                                "--iters-budget", str(STEREO_ITERS),
                                "--device", dev.type])
    launches = read_launches()
    binnings = dict(blend.train_binnings)
    losses = finite_losses(probe, "slam_stereo")
    run = harness.evaluate_run(out)
    l1 = png_l1(out)
    pairs = datasets.load_euroc_stereo(seq)
    _, est, _ = metrics.load_tum_trajectory(out / "CameraTrajectory_TUM.txt")
    gt = np.stack([
        -se3.quat_to_rotmat(torch.as_tensor(np.asarray(
            fr.quat, np.float32))).numpy().T @ np.asarray(fr.trans)
        for fr, _ in pairs[:len(est)]])
    ate = metrics.ate_rmse(est, gt)["ate_rmse"] if len(est) else np.inf
    # the app's SGM pseudo-depth (_depth_from_disparity: strided
    # semi-global matching, frontends.stereo_block_matching) on the keyframe
    # pairs: its valid share and its median relative error against the
    # maker's ground-truth depth
    calib = json.loads((seq / "calib.json").read_text())
    cam = Camera(camera_id=0, width=calib["width"], height=calib["height"],
                 fx=calib["fx"], fy=calib["fy"], cx=calib["cx"],
                 cy=calib["cy"])
    valid, rel = [], []
    for fr, right in pairs[::10]:
        d = slam_stereo._depth_from_disparity(
            datasets._imread(fr.rgb_path, grayscale=True),
            datasets._imread(right, grayscale=True), cam, calib["baseline"])
        ts = Path(fr.rgb_path).stem
        d_gt = np.load(seq / "mav0" / "depth0" / f"{ts}.npy")
        ok = (d > 0) & (d_gt > 0)
        valid.append(float((d > 0).mean()))
        rel.append(float(np.median(np.abs(d[ok] - d_gt[ok]) / d_gt[ok])))
    t = res["trainer"]
    n_kf = len(t.scene.keyframes)
    print(f"[stereo] slam_stereo --pre-rectified --tracker oracle, "
          f"{len(pairs)} pairs at 640x480, {n_kf} keyframes, "
          f"{res['iterations']} iterations: {res['ms_per_iter']:.3f} ms/iter "
          f"({1000.0 / res['ms_per_iter']:.2f} iters/s, host clock around "
          f"Mapper.run to a synchronised device); training binnings "
          f"{binnings}; launches {launches}; loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}; record_all_keyframes read back by the "
          f"harness: PSNR {run.get('psnr', float('nan')):.3f} dB, SSIM "
          f"{1.0 - run.get('dssim', float('nan')):.4f}, L1 {l1:.5f}; ATE "
          f"RMSE {ate:.3e} m over {len(est)} frames; SGM "
          f"pseudo-depth on {len(valid)} keyframe pairs: valid on "
          f"{100 * np.mean(valid):.1f} % of pixels, median relative error "
          f"{np.median(rel):.4f} against the maker's depth", flush=True)
    if res["iterations"] != STEREO_ITERS:
        fail(f"slam_stereo trained {res['iterations']} iterations")
    if binnings["packed"] != STEREO_ITERS or binnings["f32"]:
        fail(f"slam_stereo's steps did not all take the packed training "
             f"binning: {binnings}")
    if launches["blend_bwd"] != STEREO_ITERS \
            or launches["blend_fwd"] < STEREO_ITERS \
            or launches["blend_eval_packed"] < n_kf:
        fail(f"slam_stereo launched {launches}")
    if not ate <= 1e-3:
        fail(f"slam_stereo's ATE {ate} m is above 1e-3 m")
    if not np.isfinite(run.get("psnr", np.nan)):
        fail(f"slam_stereo's recorded metrics are not finite: {run}")
    if len(probe.captured) != STEREO_CHECKED[1]:
        fail(f"{len(probe.captured)} blend backwards captured in "
             f"slam_stereo, expected {STEREO_CHECKED[1]}")
    kernels = hold_training_kernels(
        probe.captured, t.raster_config,
        "slam_stereo's kmax-16 packed-binning steps at 640x480", "stereo")
    return {"launches": launches, "kernels": kernels}


def phase_apps(dev) -> dict:
    """Phase 10: the offline and stereo entry points (see the module
    docstring)."""
    return {"train_colmap": colmap_run(dev), "slam_stereo": stereo_run(dev)}


def phase_apps_apart() -> dict:
    """Phase 10 in a process of its own (`chip_smoke.py --apps`), which
    writes phase_apps' result to WORK/apps.json. After phases 3-9 in the
    same process, torch.profiler (torch 2.11 on an H100) recorded no device
    activity at all in 10d's kernel timing, while phase 10d alone in a
    process timed its kernels; a fresh process gives phase 10 the profiler
    it has alone."""
    out = WORK / "apps.json"
    out.unlink(missing_ok=True)
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--apps"], timeout=800)
    if res.returncode != 0 or not out.exists():
        fail(f"phase 10 (chip_smoke.py --apps) exited {res.returncode}")
    return json.loads(out.read_text())


def apps_main():
    """`chip_smoke.py --apps`: phase 10 alone, its result in
    WORK/apps.json."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    f32_matmuls()
    WORK.mkdir(parents=True, exist_ok=True)
    apps = phase_apps(torch.device("cuda"))
    (WORK / "apps.json").write_text(json.dumps(apps))


LAST_VIEWER_SIZE = 480
LAST_CAPACITY = 2**16  # train_colmap's, whose --out state 11a and 11d load
LAST_REQUESTS = 20  # /render requests of the checkpoint viewer
LIVE_ITERS = 300  # slam_rgbd iterations with and without the live viewer
LIVE_PERIOD_S = 0.1  # the live client's request period
LPIPS_PAIRS = 4  # rendered / ground-truth PNG pairs of run A for LPIPS
DP_RANKS = 2
DP_TIMED = 5  # dp steps timed after the compared one


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http_get(port: int, path: str, timeout: float = 120.0):
    """(status, body, ms on the host clock) of one GET."""
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        body = r.read()
        return r.status, body, (time.perf_counter() - t0) * 1e3


def _jpeg(body) -> np.ndarray:
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))


class EvalBlendRoute:
    """Within the block, K3's dispatcher (blend_forward_eval_packed, which
    binned_blend_eval calls) keeps each call's arguments in `captured` and,
    with plain=True, routes the call to K3's plain version on the same card
    tensors."""

    def __init__(self, plain: bool = False):
        self.plain, self.captured = plain, []

    def __enter__(self):
        import segs_slam_tpu_torch.ops.rasterizer.blend as blend

        self._saved = blend.blend_forward_eval_packed
        kernel = (blend.blend_forward_eval_packed_reference if self.plain
                  else self._saved)

        def route(*args):
            self.captured.append(args)
            return kernel(*args)

        blend.blend_forward_eval_packed = route
        return self

    def __exit__(self, *exc):
        import segs_slam_tpu_torch.ops.rasterizer.blend as blend

        blend.blend_forward_eval_packed = self._saved


def held_k3(args, where: str, tag: str) -> dict:
    """K3 against its plain version on one binned input (check_eval's
    gate), with its device, call and plain times and bound."""
    import segs_slam_tpu_torch.ops.rasterizer.blend as blend

    with torch.inference_mode():
        res = check_eval("blend_eval_packed", args)
        torch.cuda.synchronize()
        res["call_ms"] = cuda_ms(
            lambda: blend.blend_forward_eval_packed_cuda(*args), reps=20,
            warmup=3)
        res["ms"] = kernel_ms(
            [lambda: blend.blend_forward_eval_packed_cuda(*args)],
            KERNEL_FUNCS["blend_eval_packed"])
        res["plain_ms"] = cuda_ms(
            lambda: blend.blend_forward_eval_packed_reference(*args), reps=5)
    res.update(bound(res["work"]))
    res["pixels_per_thread"] = pixels_per_thread(args[1], True)
    print(f"[{tag}] K3 on {where}: max |err| {res['max_abs_err']:.3g} "
          f"against its plain version; device {res['ms']:.4f} ms (profiler, "
          f"mean of {DEVICE_REPS}+), call {res['call_ms']:.4f} ms, plain "
          f"{res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms "
          f"({res['bound_by']}), P {res['pixels_per_thread']}, "
          f"{int((args[2] - args[1]).sum())} instances", flush=True)
    if not res["ok"]:
        fail(f"K3 disagrees with its plain version on {where}: max |err| "
             f"{res['max_abs_err']}")
    return {k: res[k] for k in ("max_abs_err", "ms", "call_ms", "plain_ms",
                                "bound_ms", "bound_by", "pixels_per_thread")}


def viewer_checkpoint(dev) -> dict:
    """11a: the viewer app in checkpoint mode on train_colmap's --out train
    state (phase 10c), served on a free port: /, /state, then
    LAST_REQUESTS /render requests on an orbit at 480x480, each a JPEG of
    480x480x3; one frame before JPEG against the same pose rendered with
    K3's plain version (at most one 8-bit level apart); ms a request, K3's
    launches and its device time at 480x480."""
    from segs_slam_tpu_torch.apps import viewer

    size = LAST_VIEWER_SIZE
    args = viewer.parse_args([
        "--ckpt", str(WORK / "colmap_out" / "ckpt"), "--port", "0",
        "--size", str(size), "--capacity", str(LAST_CAPACITY),
        "--device", dev.type])
    t0 = time.perf_counter()
    render_pose, start, (w, h) = viewer.build_renderer(args)
    setup_s = time.perf_counter() - t0
    srv = viewer.make_server(render_pose, lambda: start, w, h, 0)
    import threading

    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        port = srv.server_address[1]
        page = _http_get(port, "/")
        state = json.loads(_http_get(port, "/state")[1])
        poses = []
        for i in range(LAST_REQUESTS):
            a = 2 * np.pi * i / LAST_REQUESTS
            pos = [state["pos"][0] + 0.3 * np.sin(a), state["pos"][1],
                   state["pos"][2] + 0.3 * (1 - np.cos(a))]
            poses.append((pos, 0.25 * np.sin(a), 0.1 * np.cos(a)))
        reset_launches()
        ms, lit = [], []
        for pos, yaw, pitch in poses:
            code, body, t = _http_get(
                port, f"/render?x={pos[0]}&y={pos[1]}&z={pos[2]}&yaw={yaw}"
                f"&pitch={pitch}")
            frame = _jpeg(body)
            if code != 200 or frame.shape != (size, size, 3):
                fail(f"viewer /render gave {code}, a frame of {frame.shape}")
            ms.append(t)
            lit.append(float((frame.max(axis=2) > 8).mean()))
        launches = read_launches()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    best = poses[int(np.argmax(lit))]
    with EvalBlendRoute() as cap:
        kernel = render_pose(*best)
    with EvalBlendRoute(plain=True):
        plain = render_pose(*best)
    levels = int(np.abs(kernel.astype(int) - plain.astype(int)).max())
    k3 = held_k3(cap.captured[0], f"the viewer's {size}x{size} frame",
                 "viewer")
    print(f"[viewer] checkpoint mode (train_colmap's --out state, capacity "
          f"2^16, {size}x{size}, set-up with calibration {setup_s:.2f} s): "
          f"/ {page[0]} in {page[2]:.2f} ms, /state {state}; "
          f"{LAST_REQUESTS} /render requests: median "
          f"{np.median(ms):.3f} ms, p90 {np.percentile(ms, 90):.3f} ms, min "
          f"{min(ms):.3f} ms (host clock around the GET: render, JPEG, "
          f"HTTP); lit share of the frames {min(lit):.3f}-{max(lit):.3f}; "
          f"launches {launches}; the most lit frame before JPEG against "
          f"K3's plain version: {levels} 8-bit levels apart", flush=True)
    if page[0] != 200 or b"<img" not in page[1]:
        fail("the viewer's page did not load")
    if launches["blend_eval_packed"] != LAST_REQUESTS \
            or launches["preprocess"] != 2 * LAST_REQUESTS or any(
                v for k, v in launches.items()
                if k not in ("blend_eval_packed", "preprocess")):
        fail(f"the viewer's {LAST_REQUESTS} renders launched {launches}")
    if levels > 1 or not max(lit) > 0:
        fail(f"the viewer's frame is {levels} levels off its plain version "
             f"(lit share {max(lit)})")
    return {"launches": launches, "k3": k3, "ms_median": float(np.median(ms)),
            "ms_p90": float(np.percentile(ms, 90))}


def viewer_live(dev) -> dict:
    """11b: slam_rgbd --tracker oracle on phase 9's sequence for LIVE_ITERS
    iterations, first without and then with --viewer-port on a free port;
    with it, a client thread requests /render every LIVE_PERIOD_S while
    the app runs: every response 200 and a 480x480 frame, the render thread
    raising nothing, the losses finite; ms a request and mapping ms/iter of
    both runs."""
    import threading

    from segs_slam_tpu_torch.apps import slam_rgbd

    seq = WORK / "slam_seq"
    runs = {}
    for live in (False, True):
        label = "with the viewer" if live else "without the viewer"
        argv = slam_argv(seq, WORK / f"live_{int(live)}", LIVE_ITERS, dev)
        port = _free_port()
        if live:
            argv += ["--viewer-port", str(port)]
        got, stop = [], threading.Event()

        def client():
            while not stop.is_set():
                try:
                    code, body, t = _http_get(port, "/render?z=-0.5")
                except OSError:  # not serving yet
                    stop.wait(0.02)
                    continue
                got.append((code, _jpeg(body).shape, t, time.perf_counter()))
                stop.wait(LIVE_PERIOD_S)

        ct = threading.Thread(target=client, daemon=True)
        if live:
            ct.start()
        reset_launches()
        try:
            with SlamProbe(dev) as probe:
                res = slam_rgbd.main(argv)
            t_end = time.perf_counter()
        finally:
            stop.set()
            ct.join(timeout=120) if live else None
        launches = read_launches()
        losses = finite_losses(probe, f"slam_rgbd {label}")
        th = res["viewer"]
        if th is not None:
            th.server.shutdown()
            th.server.server_close()
            th.join(timeout=30)
        during = [g for g in got if g[3] <= t_end]
        runs[live] = {"ms_per_iter": res["ms_per_iter"],
                      "launches": launches, "served": len(during)}
        msg = (f"[live] slam_rgbd {label}, {res['iterations']} iterations: "
               f"{res['ms_per_iter']:.3f} ms/iter (host clock around "
               f"Mapper.run to a synchronised device); launches {launches}; "
               f"loss {losses[0]:.5f} -> {losses[-1]:.5f}")
        if live:
            ms = [g[2] for g in during] or [float("nan")]
            runs[live].update(ms_median=float(np.median(ms)),
                              ms_p90=float(np.percentile(ms, 90)))
            msg += (f"; {len(during)} renders served while the app ran "
                    f"(one every {LIVE_PERIOD_S * 1e3:.0f} ms at most): "
                    f"median {np.median(ms):.3f} ms, p90 "
                    f"{np.percentile(ms, 90):.3f} ms a request (host clock "
                    f"around the GET: the wait for the Trainer's lock, the "
                    f"render, JPEG, HTTP); statuses "
                    f"{sorted({g[0] for g in got})}; render-thread errors "
                    f"{len(th.errors)}")
            if res["iterations"] != LIVE_ITERS or not during or any(
                    g[0] != 200 or g[1] != (480, 480, 3) for g in got):
                fail(f"the live viewer answered {[g[:2] for g in got]} over "
                     f"{res['iterations']} iterations")
            if th.errors:
                fail(f"the live viewer's render raised {th.errors!r}")
        print(msg, flush=True)
    extra_k3 = (runs[True]["launches"]["blend_eval_packed"]
                - runs[False]["launches"]["blend_eval_packed"])
    print(f"[live] mapping {runs[False]['ms_per_iter']:.3f} -> "
          f"{runs[True]['ms_per_iter']:.3f} ms/iter with the viewer "
          f"serving; K3 launches the viewer added: {extra_k3}", flush=True)
    if extra_k3 < 1:
        fail("the live viewer launched no K3")
    return {"launches": runs[True]["launches"], "viewer_k3": extra_k3,
            **{f"{k}_{'on' if live else 'off'}": v
               for live, r in runs.items() for k, v in r.items()
               if k != "launches"}}


def sh_path(dev) -> dict:
    """11c: rasterize(shs=...) at degree 3 on the kernel phase's 640x480
    view of the seeded full-width map (its neural gaussians with their
    opacities scaled by 4, seeded SH coefficients whose colours stay off
    sh_to_color's clamp), forward and backward
    through K1 and K2; the image and the gradients with respect to the
    coefficients and the means against the same call through the plain
    versions on the card; K1 and K2 against their plain versions on the
    call's binned input (hold_training_kernels)."""
    import segs_slam_tpu_torch.ops.rasterizer.blend as blend
    from segs_slam_tpu_torch.core import Camera, Keyframe
    from segs_slam_tpu_torch.io.convert import load_map
    from segs_slam_tpu_torch.models.renderer import neural_gaussians_for_view
    from segs_slam_tpu_torch.ops.rasterizer import RasterConfig, rasterize
    from segs_slam_tpu_torch.ops.sh import num_sh_coeffs, rgb_to_sh

    rc = RasterConfig(tile=16, compact=2**16, kmax=8, chunk=256, ksmall=4,
                      nlarge=2**13)
    anchors, decoders = load_map(WORK / "map.npz", dev)
    mc = dataclasses.replace(decoders.config,
                             capacity=anchors.anchor.shape[0])
    w, h = 640, 480
    cam = Camera(camera_id=0, width=w, height=h, fx=500.0, fy=500.0,
                 cx=w / 2, cy=h / 2)
    kf = Keyframe(kf_id=0, camera=cam, quat=[1, 0, 0, 0], trans=[0, 0, 0])
    c = {k: torch.as_tensor(v, device=dev)
         for k, v in kf.render_inputs().items()}
    with torch.no_grad():
        ng = neural_gaussians_for_view(anchors, decoders, c, w, h, mc, rc)[1]
    g = torch.Generator().manual_seed(SEED + 11)
    n = ng.xyz.shape[0]
    shs0 = (0.03 * torch.randn(n, num_sh_coeffs(3), 3, generator=g)).to(dev)
    shs0[:, 0] = rgb_to_sh(ng.color.clamp(0.2, 0.8))
    cot = torch.randn(3, h, w, generator=g).to(dev)
    bg = torch.tensor([0.25, 0.5, 0.75], device=dev)
    # the seeded map's opacities top out near 0.22, where alpha never meets
    # the 0.99 clamp; spread up to 0.87, so that the clamp is reached once
    # hold_training_kernels raises those above 0.5
    opacity = (4.0 * ng.opacity).clamp(max=0.95)

    def run():
        shs = shs0.clone().requires_grad_()
        means = ng.xyz.detach().clone().requires_grad_()
        out = rasterize(means, ng.scaling, ng.rotation, opacity,
                        torch.zeros_like(means), c["world_view_transform"],
                        c["full_proj_transform"], w, h, c["tan_fovx"],
                        c["tan_fovy"], bg, config=rc, valid=ng.valid,
                        shs=shs, sh_degree=3)
        grads = torch.autograd.grad((out["image"] * cot).sum(),
                                    [shs, means])
        _sync(dev)
        return out, grads

    captured = []
    saved = blend.blend_forward, blend.blend_backward

    def keep(*args):
        captured.append(args)
        return saved[1](*args)

    reset_launches()
    blend.blend_backward = keep
    try:
        out_k, grads_k = run()
    finally:
        blend.blend_backward = saved[1]
    launches = read_launches()
    blend.blend_forward = blend.blend_forward_reference
    blend.blend_backward = blend.blend_backward_reference
    try:
        out_p, grads_p = run()
    finally:
        blend.blend_forward, blend.blend_backward = saved
    nc_eq = out_k["n_contrib"] == out_p["n_contrib"]
    color_err = float((out_k["image"] - out_p["image"]).detach().abs()[
        nc_eq.expand_as(out_p["image"])].max())
    grad_err = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(grads_k, grads_p)]
    print(f"[sh] rasterize(shs=..., sh_degree=3) at 640x480, {n} gaussians "
          f"({int(ng.valid.sum())} valid): launches {launches}; against the "
          f"same call through the plain versions on the card: n_contrib "
          f"equal on {100 * float(nc_eq.float().mean()):.4f} % of pixels, "
          f"colour there within {color_err:.3g}; gradient error / largest: "
          f"shs {grad_err[0]:.3g}, means3d {grad_err[1]:.3g}", flush=True)
    if launches["blend_fwd"] != 1 or launches["blend_bwd"] != 1:
        fail(f"the SH render launched {launches}")
    if float(nc_eq.float().mean()) < 0.9999 or color_err > 2e-4 \
            or max(grad_err) > 2e-4 or not all(
                bool(torch.isfinite(x).all()) for x in grads_k):
        fail("the SH render on the kernels disagrees with its plain route")
    kernels = hold_training_kernels(captured, rc, "the SH render at 640x480",
                                    "sh")
    return {"launches": launches, "kernels": kernels}


def kanchor_path(dev) -> dict:
    """11d: the eval render of train_colmap's trained 640x480 map (phase
    10c's --out state) at its first view, with kanchor = n_offsets - 2 at
    calibrate_eval_config's sizes (the direct selection, pack8): K3 against
    its plain version on the binned input; the anchors that overflow
    kanchor; where none does, the binned columns equal those without
    kanchor, else the image's distance to the render without kanchor."""
    from segs_slam_tpu_torch.core import Keyframe
    from segs_slam_tpu_torch.io.checkpoint import load_train_state
    from segs_slam_tpu_torch.io.colmap import read_scene
    from segs_slam_tpu_torch.models.renderer import (
        EvalRenderer,
        calibrate_eval_config,
        project_view,
    )
    from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
    from segs_slam_tpu_torch.ops.rasterizer import binning as binning

    ts = load_train_state(WORK / "colmap_out" / "ckpt", device=dev)
    mc = dataclasses.replace(ts.decoders.config,
                             capacity=ts.anchors.anchor.shape[0])
    scene = read_scene(WORK / "colmap_scene" / "sparse" / "0")
    cam0 = next(iter(scene.cameras.values()))
    fx, fy, cx, cy = cam0.focal_and_center()
    from segs_slam_tpu_torch.core import Camera

    cam = Camera(camera_id=0, width=cam0.width, height=cam0.height, fx=fx,
                 fy=fy, cx=cx, cy=cy)
    img = scene.images[min(scene.images)]
    kf = Keyframe(kf_id=0, camera=cam, quat=img.qvec, trans=img.tvec)
    c = {k: torch.as_tensor(v, device=dev)
         for k, v in kf.render_inputs().items()}
    w, h = cam.width, cam.height
    ka = mc.n_offsets - 2
    base = RasterConfig(tile=16, compact=2**16, kmax=8, chunk=256, ksmall=4,
                        nlarge=2**13)
    cal0 = calibrate_eval_config(base, mc, ts.anchors, ts.decoders, [c], w, h)
    cal = dataclasses.replace(cal0, kanchor=ka, kgroup=mc.n_offsets)
    bg = torch.zeros(3, device=dev)
    reset_launches()
    with EvalBlendRoute() as cap:
        image = EvalRenderer(mc, cal, w, h, bg, device=dev)(
            ts.anchors, ts.decoders, c)
        _sync(dev)
    launches = read_launches()
    with torch.no_grad():
        ref = EvalRenderer(mc, cal0, w, h, bg, device=dev)(
            ts.anchors, ts.decoders, c)
        _, _, _, feats, aux = project_view(ts.anchors, ts.decoders, c, w, h,
                                           mc, cal)
        per_anchor = aux["alive"].reshape(-1, mc.n_offsets).sum(dim=1)
        overflow = int((per_anchor > ka).sum())
        visible = int((per_anchor > 0).sum())
        tx, ty = cal.grid(w, h)
        got = binning.bin_eval_direct(feats, aux, tx, ty, cal, True)
        plain = binning.bin_eval_direct(feats, aux, tx, ty, cal0, True)
    # the live instances' columns and the tile ranges (the slots past
    # num_instances hold whichever dead rows the selection put last)
    n_live = int(got[3])
    same = (n_live == int(plain[3])
            and torch.equal(got[0][:, :n_live], plain[0][:, :n_live])
            and all(torch.equal(a, b) for a, b in zip(got[1:3], plain[1:3])))
    diff = (image - ref).abs()
    k3 = held_k3(cap.captured[0], "the kanchor eval render of the trained "
                 "640x480 map", "kanchor")
    print(f"[kanchor] train_colmap's trained map at its first view "
          f"({w}x{h}), kanchor {ka} of {mc.n_offsets}: launches {launches}; "
          f"{overflow} of {visible} anchors with an alive offset overflow "
          f"kanchor; binned columns equal to those without kanchor: {same}; "
          f"image against the render without kanchor: max {diff.max():.4g}, "
          f"mean {diff.mean():.4g}; instances {int(got[3])} against "
          f"{int(plain[3])}", flush=True)
    if launches["blend_eval_packed"] != 1:
        fail(f"the kanchor eval render launched {launches}")
    if overflow == 0 and not same:
        fail("no anchor overflows kanchor, yet the binned columns differ")
    if not bool(torch.isfinite(image).all()) or float(diff.mean()) > 2e-2:
        fail(f"the kanchor image is {float(diff.mean())} off on average")
    return {"launches": launches, "k3": k3, "overflow": overflow}


def random_lpips_weights(seed: int) -> dict:
    """AlexNet-shaped LPIPS weights from a seed (full channel counts, tiny
    magnitudes, nonnegative heads): no pretrained weights ship with the
    repository."""
    rng = np.random.default_rng(seed)
    shapes = {"conv1_w": (64, 3, 11, 11), "conv1_b": (64,),
              "conv2_w": (192, 64, 5, 5), "conv2_b": (192,),
              "conv3_w": (384, 192, 3, 3), "conv3_b": (384,),
              "conv4_w": (256, 384, 3, 3), "conv4_b": (256,),
              "conv5_w": (256, 256, 3, 3), "conv5_b": (256,),
              "lin0": (64,), "lin1": (192,), "lin2": (384,), "lin3": (256,),
              "lin4": (256,)}
    params = {k: rng.normal(0, 0.05, s).astype(np.float32)
              for k, s in shapes.items()}
    for i in range(5):
        params[f"lin{i}"] = np.abs(params[f"lin{i}"])
    params["shift"] = np.array([-0.030, -0.088, -0.188], np.float32)
    params["scale"] = np.array([0.458, 0.448, 0.450], np.float32)
    return params


def lpips_path(dev) -> dict:
    """11e: evaluate_run's lpips column over LPIPS_PAIRS of run A's
    recorded 640x480 keyframe PNGs (phase 9), with SEGS_LPIPS_WEIGHTS naming
    a random AlexNet-shaped pickle written under build/: on the card
    against the CPU, rel 2e-4."""
    import os
    import pickle
    import shutil

    from segs_slam_tpu_torch.eval import harness

    run = WORK / "lpips_run"
    shutil.rmtree(run, ignore_errors=True)
    src = WORK / "slam_a"
    for sub in ("rendered", "ground_truth"):
        (run / sub).mkdir(parents=True)
        for p in sorted((src / sub).glob("*.png"))[:LPIPS_PAIRS]:
            shutil.copy(p, run / sub / p.name)
    weights = WORK / "lpips_random.pkl"
    with open(weights, "wb") as f:
        pickle.dump(random_lpips_weights(SEED + 12), f)
    os.environ["SEGS_LPIPS_WEIGHTS"] = str(weights)
    try:
        out, secs = [], []
        for d in (dev, torch.device("cpu")):
            t0 = time.perf_counter()
            out.append(harness.evaluate_run(run, device=d).get("lpips"))
            secs.append(time.perf_counter() - t0)
    finally:
        del os.environ["SEGS_LPIPS_WEIGHTS"]
    card, cpu = out
    rel = abs(card - cpu) / abs(cpu) if card and cpu else float("inf")
    print(f"[lpips] evaluate_run over {LPIPS_PAIRS} of run A's 640x480 "
          f"keyframe pairs, random AlexNet-shaped weights: card {card!r} "
          f"({secs[0]:.2f} s), CPU {cpu!r} ({secs[1]:.2f} s), relative "
          f"difference {rel:.3g}", flush=True)
    if not rel <= 2e-4 or not card > 0:
        fail(f"LPIPS on the card {card} against the CPU {cpu}")
    return {"lpips": card, "rel": rel}


def dp_inputs(dev) -> Path:
    """The dp phase's inputs: train_synthetic's Trainer at its defaults
    (256x256, capacity 2^14), the densify statistics' window opened at the
    first step, its state and first keyframe, saved for the ranks."""
    from segs_slam_tpu_torch.apps import train_synthetic

    trainer, _ = train_synthetic.build_trainer(["--device", dev.type])
    kf = trainer.scene.keyframes[min(trainer.scene.keyframes)]
    cam, gt = trainer._kf_inputs(kf)
    path = WORK / "dp_inputs.pt"
    torch.save({"state": trainer.state, "cam": cam, "gt": gt,
                "mc": trainer.model_config,
                "oc": dataclasses.replace(trainer.opt_config, start_stat=0),
                "rc": trainer.raster_config, "w": trainer.width,
                "h": trainer.height, "device": dev.type}, path)
    return path


def dp_step(group, d: dict, dev):
    """One (dp or single) step from the saved inputs: (state after it,
    metrics, launches, ms of DP_TIMED further steps)."""
    from segs_slam_tpu_torch.parallel.dp import make_dp_train_step
    from segs_slam_tpu_torch.train.step import make_train_step

    args = (d["mc"], d["oc"], d["rc"], d["w"], d["h"])
    step = (make_dp_train_step(group, *args) if group is not None
            else make_train_step(*args))
    bg = torch.zeros(3, device=dev)
    ts = d["state"]
    reset_launches()
    ts, m = step(ts, d["cam"], d["gt"], bg)
    _sync(dev)
    launches = read_launches()
    after = copy_state(ts)
    ms = []
    for _ in range(DP_TIMED):
        t0 = time.perf_counter()
        ts, _ = step(ts, d["cam"], d["gt"], bg)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return after, {k: float(v) for k, v in m.items()}, launches, ms


def copy_state(ts) -> dict:
    """The state's map, decoder and statistics tensors, copied to the
    host."""
    out = {f"anchors.{k}": v.detach().cpu().clone()
           for k, v in ts.anchors.params().items()}
    out.update({f"decoders.{k}": v.detach().cpu().clone()
                for k, v in ts.decoders.named_parameters()})
    out.update({f"stats.{f.name}": getattr(ts.stats, f.name).cpu().clone()
                for f in dataclasses.fields(ts.stats)})
    return out


def dp_rank_main(rank: int, work: Path):
    """`chip_smoke.py --dp-rank R WORK`: one rank of the dp phase (gloo,
    which all-reduces CUDA tensors; NCCL refuses two ranks on one card), on
    the inputs dp_inputs saved under `work`."""
    import torch.distributed as dist

    f32_matmuls()
    dist.init_process_group(
        "gloo", init_method=f"file://{work / 'dp_rendezvous'}",
        world_size=DP_RANKS, rank=rank)
    try:
        d = torch.load(work / "dp_inputs.pt", weights_only=False)
        dev = torch.device(d["device"])
        after, m, launches, ms = dp_step(dist.group.WORLD, d, dev)
        torch.save({"state": after, "metrics": m, "launches": launches,
                    "ms": ms}, work / f"dp_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def dp_path(dev) -> dict:
    """11f: DP_RANKS gloo ranks on the card, one make_dp_train_step each on
    replicated inputs (train_synthetic's first keyframe at 256x256): the
    update equals the single-process step's (rtol 1e-4, atol 1e-5), the
    densify deltas are DP_RANKS times the single step's, the ranks' states
    are equal; each rank's K1/K2 launches and the step's ms."""
    for f in [WORK / "dp_rendezvous"] + [WORK / f"dp_rank{r}.pt"
                                         for r in range(DP_RANKS)]:
        f.unlink(missing_ok=True)
    d = torch.load(dp_inputs(dev), map_location=dev, weights_only=False)
    init = copy_state(d["state"])
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--dp-rank", str(r), str(WORK)])
             for r in range(DP_RANKS)]
    codes = [p.wait(timeout=600) for p in procs]
    if any(codes):
        fail(f"the dp ranks exited {codes}")
    ranks = [torch.load(WORK / f"dp_rank{r}.pt", weights_only=False)
             for r in range(DP_RANKS)]
    single, m1, launches1, ms1 = dp_step(None, d, dev)
    worst = {"params": 0.0, "stats": 0.0}
    for k, ref in single.items():
        got = ranks[0]["state"][k]
        if not torch.equal(got, ranks[1]["state"][k]):
            fail(f"the dp ranks' {k} differ")
        if k.startswith("stats."):
            ref = init[k] + DP_RANKS * (ref - init[k])
        tol = 1e-5 + 1e-4 * ref.abs()
        if not bool(((got - ref).abs() <= tol).all()):
            fail(f"the dp update's {k} is off the single step's: max "
                 f"{float((got - ref).abs().max())}")
        kind = "stats" if k.startswith("stats.") else "params"
        worst[kind] = max(worst[kind], float((got - ref).abs().max()))
    grew = float((single["stats.offset_denom"]
                  - init["stats.offset_denom"]).sum())
    print(f"[dp] {DP_RANKS} gloo ranks on the card, train_synthetic's state "
          f"at 256x256, replicated keyframe: launches a rank "
          f"{[r['launches'] for r in ranks]} (single step {launches1}); "
          f"loss {ranks[0]['metrics']['loss']:.6f} (single "
          f"{m1['loss']:.6f}); worst |dp - single| params "
          f"{worst['params']:.3g}, stats against {DP_RANKS} x the single "
          f"delta {worst['stats']:.3g}; ranks equal; step ms (host clock to "
          f"a synchronised device, {DP_TIMED} steps) dp median "
          f"{np.median(ranks[0]['ms']):.3f} (rank 1 "
          f"{np.median(ranks[1]['ms']):.3f}), single "
          f"{np.median(ms1):.3f}", flush=True)
    if not grew > 0:
        fail("the dp step's densify statistics did not grow")
    for r in ranks:
        if r["launches"]["blend_fwd"] != 1 or r["launches"]["blend_bwd"] != 1:
            fail(f"a dp rank launched {r['launches']}")
    return {"launches": ranks[0]["launches"],
            "ms": float(np.median(ranks[0]["ms"])),
            "single_ms": float(np.median(ms1))}


def phase_last(dev) -> dict:
    """Phase 11: the viewer (checkpoint and live), SH, kanchor, LPIPS and
    the dp step (see the module docstring)."""
    return {"viewer": viewer_checkpoint(dev), "live": viewer_live(dev),
            "sh": sh_path(dev), "kanchor": kanchor_path(dev),
            "lpips": lpips_path(dev), "dp": dp_path(dev)}


def phase_last_apart() -> dict:
    """Phase 11 in a process of its own (`chip_smoke.py --last`), as phase
    10, its result through WORK/last.json."""
    out = WORK / "last.json"
    out.unlink(missing_ok=True)
    res = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--last"], timeout=600)
    if res.returncode != 0 or not out.exists():
        fail(f"phase 11 (chip_smoke.py --last) exited {res.returncode}")
    return json.loads(out.read_text())


def last_main():
    """`chip_smoke.py --last`: phase 11 alone, its result in
    WORK/last.json."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    f32_matmuls()
    t0 = time.perf_counter()
    res = phase_last(torch.device("cuda"))
    print(f"[last] phase 11 in {time.perf_counter() - t0:.1f} s", flush=True)
    (WORK / "last.json").write_text(json.dumps(res))


def print_ranking(launches, trained, at_640):
    """The kernels ranked by the device time the main path loses in them:
    launches in the train_synthetic run x (device ms - bound ms), on the
    trained map's inputs (K4: the 640x480 view), and the same at 640x480
    for the launches of a run at that size."""
    rows = []
    for name in BLEND_KERNELS:
        t, v = trained[name], at_640[name]
        rows.append((launches[name] * (t["ms"] - t["bound_ms"]), name,
                     launches[name],
                     launches[name] * (v["ms"] - v["bound_ms"])))
    rows.sort(reverse=True)
    print("[rank] launches x (device ms - bound ms), train_synthetic run, "
          "trained-map inputs (at 640x480 in brackets): "
          + "; ".join(f"{name} {n} x -> {lost:.3f} ms ({lost640:.3f} ms)"
                      for lost, name, n, lost640 in rows), flush=True)
    keys = ("ms", "call_ms", "bound_ms", "pixels_per_thread")
    print("[rank] device ms / call ms / bound ms / pixels a thread: trained "
          + json.dumps({n: [round(trained[n][k], 4) for k in keys]
                        for n in BLEND_KERNELS})
          + "; 640x480 "
          + json.dumps({n: [round(at_640[n][k], 4) for k in keys]
                        for n in BLEND_KERNELS}), flush=True)


def print_slam_ranking(launches, slam, trained):
    """launches in slam_rgbd's run A x (device ms - bound ms): K1 and K2 on
    run A's own packed-binning steps, K3 on the trained map's keyframes."""
    rows = sorted(
        ((launches[n] * (v["ms"] - v["bound_ms"]), n, launches[n])
         for n, v in (("blend_fwd", slam["blend_fwd"]),
                      ("blend_bwd", slam["blend_bwd"]),
                      ("blend_eval_packed", trained["blend_eval_packed"]))),
        reverse=True)
    print("[rank] slam_rgbd run A: launches x (device ms - bound ms): "
          + "; ".join(f"{n} {k} x -> {lost:.3f} ms" for lost, n, k in rows),
          flush=True)


def main():
    t_start = time.perf_counter()
    phase_device()
    from segs_slam_tpu_torch.io.convert import load_map, save_map
    from segs_slam_tpu_torch.models.config import ModelConfig
    from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
    from segs_slam_tpu_torch.utils.synthetic import seeded_map

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
    at_640 = phase_kernels(anchors, decoders, mc, rc, dev)
    evals = phase_eval_kernels(anchors, decoders, mc, rc, dev)
    at_640["blend_eval_packed"] = evals["K3 pack8"]
    at_640["blend_eval"] = evals["K4"]
    k5 = phase_preprocess_kernel(anchors, decoders, mc, rc, dev)
    del anchors, decoders
    phase_render_path(map_path, rc, mc)
    launches = phase_train_path()
    kernels = phase_trained()
    kernels["blend_eval"] = dict(evals["K4"], library_ms=None)
    kernels["preprocess"] = k5
    phase_densify()
    phase_small_input(dev)
    print_ranking(launches, kernels, at_640)
    slam = phase_slam(dev)
    print_slam_ranking(slam["launches"], slam["kernels"], kernels)
    apps = phase_apps_apart()
    last = phase_last_apart()

    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    # launches: this slice's main path, run A of slam_rgbd (phase 9), with
    # each path's counts beside them; K1 and K2 numbers from run A's
    # packed-binning steps (phase 9), with those on train_colmap's and
    # slam_stereo's own steps (phase 10) under numbers_by_path; K3's from
    # the trained map (phase 6), K4's and K5's from the 640x480 view
    # (phase 3)
    kernels.update(slam["kernels"])
    for name in ("blend_fwd", "blend_bwd"):
        kernels[name]["numbers_by_path"] = {
            path: apps[path]["kernels"][name]
            for path in ("train_colmap", "slam_stereo")}
        kernels[name]["numbers_by_path"]["sh"] = last["sh"]["kernels"][name]
    kernels["blend_eval_packed"]["numbers_by_path"] = {
        "viewer_480": last["viewer"]["k3"], "kanchor": last["kanchor"]["k3"]}
    by_path = {"slam_rgbd": slam["launches"], "slam_rgbd_b":
               slam["launches_b"], "train_synthetic": launches,
               "train_colmap": apps["train_colmap"]["launches"],
               "slam_stereo": apps["slam_stereo"]["launches"],
               "viewer_checkpoint": last["viewer"]["launches"],
               "slam_rgbd_live_viewer": last["live"]["launches"],
               "sh": last["sh"]["launches"],
               "kanchor": last["kanchor"]["launches"],
               "dp_rank": last["dp"]["launches"]}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": slam["launches"][name], **kernels[name],
         "launches_by_path": {k: v[name] for k, v in by_path.items()}}
        for name, (src, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--apps"]:
        apps_main()
    elif sys.argv[1:] == ["--last"]:
        last_main()
    elif sys.argv[1:2] == ["--dp-rank"]:
        dp_rank_main(int(sys.argv[2]), Path(sys.argv[3]))
    else:
        main()
