"""The blend kernels K1-K4 (csrc/blend_fwd.cu, blend_bwd.cu, blend_eval.cu)
against an earlier version of the same kernels, in one process on one card,
on the inputs that chip_smoke.py gives them:

  640x480  the 640x480 view of the seeded full-width map (1,200 tiles): K1
           and K2 on its f32 binning, K3 on its pack8 columns (direct
           selection) and its f16 columns (compaction branch), K4 on the
           compaction branch's f32 rows, at calibrate_eval_config's sizes;
  480x480  K3 (pack8) on the 8 orbit views of the same map that the
           render_views app renders (900 tiles);
  trained  24 steps of the train_synthetic map after 300 iterations (K1,
           K2) and K3 (pack8) on the 24 keyframes of its evaluate (256
           tiles of 256x256).

    python -m segs_slam_tpu_torch.tools.blend_ab [--kernels K1,K2,K3,K4] \\
        [--baseline OTHER_CHECKOUT/segs_slam_tpu_torch/csrc] [--out FILE]

The baseline's kernels, of those chosen with --kernels, take the first
versions' C interface: no pixels a thread, and K2's output zero-filled by
the caller. Each variant (the baseline, and this checkout's kernels at each
of blend.KERNEL_PIXELS) is timed in turns, the baseline first and last and
each variant twice, by the mean device duration that torch.profiler records
over at least 20 launches on each input (kernel_timing.device_ms), and by
CUDA events around one call (kernel_timing.event_ms). This checkout's
variants are held to the plain versions, run on the card, on every input:
K1's n_contrib equal on >= 99.99 % of pixels, colour and final_T within
2e-4 where it is; each K2 gradient row within 1e-4 of its largest; K3's and
K4's colour within 2e-4 on every pixel. Prints one JSON line, also written
to --out; exits 1 if a check fails. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import segs_slam_tpu_torch.ops.rasterizer.blend as blend
from segs_slam_tpu_torch.ops.cuda_lib import ROOT, build_library, check
from segs_slam_tpu_torch.utils.kernel_timing import (
    device_ms,
    event_ms,
    tile_counts,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the first versions' C interface
_BASE_ARGTYPES = {
    "blend_fwd": [_P, ctypes.c_longlong, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                  _P, _P, _P, _P, _P],
    "blend_bwd": [_P, ctypes.c_longlong, _P, _P, _P, _I, _I, _I, _F, _F, _P,
                  _P, _P, _P, _P, _P, _P],
    "blend_eval": [_P, _I, ctypes.c_longlong, _P, _P, _P, _I, _I, _I, _F, _F,
                   _F, _P, _P],
}
# the kernels timed, by what --kernels names, and each one's library
GROUPS = {"K1": ("K1",), "K2": ("K2",), "K3": ("K3 pack8", "K3 f16"),
          "K4": ("K4",)}
LIBRARY = {"K1": "blend_fwd", "K2": "blend_bwd", "K3 pack8": "blend_eval",
           "K3 f16": "blend_eval", "K4": "blend_eval"}
KERNEL_FUNCS = {"blend_fwd": "blend_fwd_kernel",
                "blend_bwd": "blend_bwd_kernel",
                "blend_eval": "blend_eval_kernel"}
REPS = 20
TRAINED_STEPS = 24
N_VIEWS = 8


def baseline_kernels(csrc: Path, kernels) -> dict:
    """The baseline's kernels as functions with the wrappers' arguments."""
    fns = {}
    for name in sorted({LIBRARY[k] for k in kernels}):
        lib = ctypes.CDLL(str(build_library(name, csrc)))
        lib.segs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.segs_cuda_error_string.restype = ctypes.c_char_p
        fn = getattr(lib, f"segs_{name}")
        fn.argtypes, fn.restype = _BASE_ARGTYPES[name], ctypes.c_int
        fns[name] = (lib, fn)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fwd(feats, start, stop, bg, tiles_x, rc):
        lib, fn = fns["blend_fwd"]
        nt, npix = start.shape[0], rc.tile * rc.tile
        out = [torch.empty((nt, c, npix), dtype=dt, device=feats.device)
               for c, dt in ((3, torch.float32), (1, torch.float32),
                             (1, torch.float32), (1, torch.int32))]
        code = fn(feats.data_ptr(), feats.shape[1], start.data_ptr(),
                  stop.data_ptr(), bg.data_ptr(), nt, tiles_x, rc.tile,
                  rc.alpha_min, rc.alpha_clamp, rc.transmittance_min,
                  *(x.data_ptr() for x in out), stream())
        check(lib, code, "baseline blend_fwd launch")
        return tuple(out)

    def bwd(feats, start, stop, bg, tiles_x, rc, dcolor, ddepth, dfinal_t,
            final_t, ncontrib):
        lib, fn = fns["blend_bwd"]
        dfeats = torch.zeros_like(feats)
        code = fn(feats.data_ptr(), feats.shape[1], start.data_ptr(),
                  stop.data_ptr(), bg.data_ptr(), start.shape[0], tiles_x,
                  rc.tile, rc.alpha_min, rc.alpha_clamp,
                  *(x.data_ptr() for x in (dcolor, ddepth, dfinal_t, final_t,
                                           ncontrib, dfeats)), stream())
        check(lib, code, "baseline blend_bwd launch")
        return dfeats

    def eval_(x, start, stop, bg, tiles_x, rc):
        lib, fn = fns["blend_eval"]
        nt = start.shape[0]
        layout = (blend._EVAL_F32 if x.dtype == torch.float32 else
                  blend._EVAL_PACK8 if rc.pack8 else blend._EVAL_F16)
        color = torch.empty((nt, 3, rc.tile * rc.tile), dtype=torch.float32,
                            device=x.device)
        code = fn(x.data_ptr(), layout, x.shape[1], start.data_ptr(),
                  stop.data_ptr(), bg.data_ptr(), nt, tiles_x, rc.tile,
                  rc.alpha_min, rc.alpha_clamp, rc.transmittance_min,
                  color.data_ptr(), stream())
        check(lib, code, "baseline blend_eval launch")
        return color

    every = {"K1": fwd, "K2": bwd, "K3 pack8": eval_, "K3 f16": eval_,
             "K4": eval_}
    return {k: every[k] for k in kernels}


def at_pixels(fn, p: int):
    """fn with the wrappers' pixels-a-thread choice forced to p."""
    def call(*args):
        saved = blend._pixels_per_thread
        blend._pixels_per_thread = lambda *_: p
        try:
            return fn(*args)
        finally:
            blend._pixels_per_thread = saved
    return call


def variant_kernels(p: int, kernels) -> dict:
    every = {"K1": blend.blend_forward_cuda, "K2": blend.blend_backward_cuda,
             "K3 pack8": blend.blend_forward_eval_packed_cuda,
             "K3 f16": blend.blend_forward_eval_packed_cuda,
             "K4": blend.blend_forward_eval_cuda}
    return {k: at_pixels(every[k], p) for k in kernels}


def seeded_view_map(dev):
    """chip_smoke.py's seeded full-width map: (anchors, decoders, model
    config, the app's training raster config, numpy arrays)."""
    from segs_slam_tpu_torch.io.convert import (
        anchors_from_numpy,
        decoders_from_jax,
        flatten_params,
    )
    from segs_slam_tpu_torch.models.config import ModelConfig
    from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
    from segs_slam_tpu_torch.utils.synthetic import seeded_map

    mc = ModelConfig()
    anchors_np, dec_np = seeded_map(mc, n_active=2**15, seed=0)
    rc = RasterConfig(tile=16, compact=2**16, kmax=8, chunk=256, ksmall=4,
                      nlarge=2**13)
    return (anchors_from_numpy(anchors_np, dev),
            decoders_from_jax(flatten_params(dec_np), dev), mc, rc,
            (anchors_np, dec_np))


def view_inputs(dev, seeded) -> dict:
    """Each kernel's arguments on chip_smoke.py's 640x480 kernel-phase view:
    K2's with its seeded cotangents (K1's are their first six), K3's and
    K4's at the view's calibrated eval config."""
    import segs_slam_tpu_torch.ops.rasterizer.binning as binning
    from segs_slam_tpu_torch.core import Camera, Keyframe
    from segs_slam_tpu_torch.models.renderer import (
        calibrate_eval_config,
        project_view,
    )

    anchors, decoders, mc, rc, _ = seeded
    w, h = 640, 480
    cam = Camera(camera_id=0, width=w, height=h, fx=500.0, fy=500.0,
                 cx=w / 2, cy=h / 2)
    kf = Keyframe(kf_id=0, camera=cam, quat=[1, 0, 0, 0], trans=[0, 0, 0])
    c = {k: torch.as_tensor(v, device=dev)
         for k, v in kf.render_inputs().items()}
    tx, ty = rc.grid(w, h)
    bg = torch.tensor([0.25, 0.5, 0.75], device=dev)
    with torch.inference_mode():
        _, _, _, feats, aux = project_view(anchors, decoders, c, w, h, mc, rc)
        b = binning.expand_and_sort(binning.compact_gaussians(feats, aux, rc),
                                    tx, ty, rc)
        args = (b.feats_sorted, b.tile_start, b.tile_stop, bg, tx, rc)
        _, final_t, _, ncontrib = blend.blend_forward_reference(*args)
    nt = tx * ty
    g = torch.Generator().manual_seed(2)
    cot = (torch.randn(nt, 3, 256, generator=g),
           0.1 * torch.randn(nt, 1, 256, generator=g),
           torch.randn(nt, 1, 256, generator=g))
    out = {"K1": [args],
           "K2": [(*args, *(x.to(dev) for x in cot), final_t, ncontrib)]}

    cal = calibrate_eval_config(rc, mc, anchors, decoders, [c], w, h)
    f16 = dataclasses.replace(cal, sel_direct=False, pack8=False)
    with torch.inference_mode():
        _, _, _, feats, aux = project_view(anchors, decoders, c, w, h, mc,
                                           cal)
        cols, start, stop, _, _ = binning.bin_eval_direct(
            feats, aux, tx, ty, cal, return_packed=True)
        pc = binning.compact_gaussians_packed(feats, aux, f16)
        c16, s16, e16, _, _ = binning.expand_and_sort_packed(
            pc, tx, ty, f16, return_packed=True)
        f32, s32, e32, _, _ = binning.expand_and_sort_packed(pc, tx, ty, f16)
    out["K3 pack8"] = [(binning.as_u32_bits(cols), start, stop, bg, tx, cal)]
    out["K3 f16"] = [(binning.as_u32_bits(c16), s16, e16, bg, tx, f16)]
    out["K4"] = [(f32, s32, e32, bg, tx, f16)]
    return out


def captured_eval(run) -> list:
    """The K3 arguments of the blend_forward_eval_packed calls that run()
    makes."""
    captured = []
    packed = blend.blend_forward_eval_packed

    def recording(*args):
        captured.append(args)
        return packed(*args)

    blend.blend_forward_eval_packed = recording
    try:
        run()
    finally:
        blend.blend_forward_eval_packed = packed
    return captured


def orbit_inputs(seeded) -> dict:
    """K3's arguments on the render_views app's N_VIEWS orbit views of the
    seeded map at 480x480 (the app calibrates its eval config itself)."""
    from segs_slam_tpu_torch.apps import render_views
    from segs_slam_tpu_torch.io.convert import save_map

    *_, rc, (anchors_np, dec_np) = seeded
    work = ROOT / "build" / "blend_ab"
    work.mkdir(parents=True, exist_ok=True)
    save_map(work / "map.npz", anchors_np, dec_np)
    argv = ["--map", str(work / "map.npz"), "--out", str(work / "views"),
            "--size", "480", "--orbit-frames", str(N_VIEWS), "--compact",
            str(rc.compact), "--kmax", str(rc.kmax), "--ksmall",
            str(rc.ksmall), "--nlarge", str(rc.nlarge), "--device", "cuda"]
    return {"K3 pack8": captured_eval(lambda: render_views.main(argv))}


def trained_inputs() -> dict:
    """K2's arguments (K1's are their first six) on TRAINED_STEPS steps of
    train_synthetic's map (full width, --freq-reg) after 300 iterations, and
    K3's on the keyframes of its evaluate."""
    from segs_slam_tpu_torch.apps.train_synthetic import build_trainer

    t, _ = build_trainer(["--iters", "300", "--freq-reg", "--device",
                          "cuda"])
    t.train(300)
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
    t.reset_eval_renderer()  # calibrated on the trained map
    return {"K1": captured, "K2": captured,
            "K3 pack8": captured_eval(t.evaluate)}


def kernel_args(kernel: str, a: tuple) -> tuple:
    return a[:6] if kernel == "K1" else a


def check_variant(kernel: str, fn, inputs) -> dict:
    """The variant against the plain version, on the card, on every
    input."""
    worst = {"err": 0.0}
    ok = True
    plain = {"K3 pack8": blend.blend_forward_eval_packed_reference,
             "K3 f16": blend.blend_forward_eval_packed_reference,
             "K4": blend.blend_forward_eval_reference}
    with torch.inference_mode():
        for a in inputs:
            if kernel == "K1":
                got = fn(*a[:6])
                ref = blend.blend_forward_reference(*a[:6])
                eq = got[3] == ref[3]
                err = max(float(((g - r).abs())[eq.expand_as(r)].max())
                          for g, r in zip(got[:2], ref[:2]))
                share = float(eq.float().mean())
                ok &= share >= 0.9999 and err <= 2e-4
                worst["nc_equal"] = min(worst.get("nc_equal", 1.0), share)
            elif kernel == "K2":
                got = fn(*a)
                ref = blend.blend_backward_reference(*a)
                scale = ref.abs().amax(dim=1).clamp(min=1e-30)
                err = float(((got - ref).abs().amax(dim=1) / scale).max())
                ok &= bool(torch.isfinite(got).all()) and err <= 1e-4
            else:
                got = fn(*a)
                err = float((got - plain[kernel](*a)).abs().max())
                ok &= bool(torch.isfinite(got).all()) and err <= 2e-4
            worst["err"] = max(worst["err"], err)
    return dict(worst, ok=bool(ok))


def time_set(inputs: dict, variants: dict) -> dict:
    """Each kernel's variants in turns: names in order, then reversed."""
    res = {}
    order = list(variants) + list(reversed(variants))
    for kernel, args in inputs.items():
        calls = {name: [(lambda f=v[kernel], a=a:
                         f(*kernel_args(kernel, a))) for a in args]
                 for name, v in variants.items()}
        runs = {name: [] for name in variants}
        func = KERNEL_FUNCS[LIBRARY[kernel]]
        with torch.inference_mode():
            for name in order:
                runs[name].append(device_ms(calls[name], func, reps=REPS))
            call_ms = {name: float(np.mean([event_ms(c, reps=5, warmup=1)
                                            for c in calls[name]]))
                       for name in variants}
        res[kernel] = {name: {"device_ms": float(np.mean(r)), "runs": r,
                              "call_ms": call_ms[name]}
                       for name, r in runs.items()}
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--kernels", default="K1,K2,K3,K4",
                   help="comma-separated, of " + ", ".join(GROUPS))
    p.add_argument("--baseline", type=Path, default=None,
                   help="another checkout's segs_slam_tpu_torch/csrc")
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    kernels = [k for g in args.kernels.split(",") for k in GROUPS[g]]
    if not torch.cuda.is_available():
        sys.exit("blend_ab needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    variants = {}
    if args.baseline is not None:
        variants["baseline"] = baseline_kernels(args.baseline, kernels)
    for p_ in blend.KERNEL_PIXELS:
        variants[f"P{p_}"] = variant_kernels(p_, kernels)

    seeded = seeded_view_map(dev)
    out = {"device": smi, "reps": REPS, "sets": {}}
    ok = True
    for set_name, make in (("640x480", lambda: view_inputs(dev, seeded)),
                           ("480x480", lambda: orbit_inputs(seeded)),
                           ("trained", trained_inputs)):
        inputs = {k: v for k, v in make().items() if k in kernels}
        if not inputs:
            continue
        checks = {f"{k} {name}": check_variant(k, v[k], inputs[k])
                  for name, v in variants.items() if name != "baseline"
                  for k in inputs}
        ok &= all(c["ok"] for c in checks.values())
        out["sets"][set_name] = {
            "inputs": {k: len(a) for k, a in inputs.items()},
            "tiles": {k: int(a[0][1].shape[0]) for k, a in inputs.items()},
            "instances_a_tile": {
                k: tile_counts(torch.cat([x[1] for x in a]),
                               torch.cat([x[2] for x in a]))
                for k, a in inputs.items()},
            "checks": checks, "times": time_set(inputs, variants)}
        print(f"[blend_ab] {set_name}: "
              + json.dumps({k: {n: round(v["device_ms"], 5)
                                for n, v in t.items()}
                            for k, t in out["sets"][set_name][
                                "times"].items()}), flush=True)
    out["ok"] = bool(ok)
    line = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)
    if not ok:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
