"""K1 and K2 (csrc/blend_fwd.cu, csrc/blend_bwd.cu) against an earlier
version of the same kernels, in one process on one card, on the inputs that
chip_smoke.py gives them: the 640x480 view of the seeded full-width map
(1,200 tiles) and 24 steps of the train_synthetic map after 300 iterations
(256 tiles of 256x256).

    python -m segs_slam_tpu_torch.tools.blend_ab \\
        [--baseline OTHER_CHECKOUT/segs_slam_tpu_torch/csrc] [--out FILE]

The baseline's kernels take the first versions' C interface (no pixels a
thread; K2's output zero-filled by the caller). Each variant (the baseline,
and this checkout's kernels at each of blend.KERNEL_PIXELS) is timed in
turns, the baseline first and last and each variant twice, by the mean
device duration that torch.profiler records over at least 20 launches on
each input (kernel_timing.device_ms), and by CUDA events around one call
(kernel_timing.event_ms). This checkout's variants are held to the plain
versions on every input: n_contrib equal on >= 99.99 % of pixels, colour
and final_T within 2e-4 where it is; each K2 gradient row within 1e-4 of its
largest. Prints one JSON line, also written to --out; exits 1 if a check
fails. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import segs_slam_tpu_torch.ops.rasterizer.blend as blend
from segs_slam_tpu_torch.ops.cuda_lib import build_library, check
from segs_slam_tpu_torch.utils.kernel_timing import (
    device_ms,
    event_ms,
    tile_counts,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the first versions' C interface (PRs 1 and 2)
_BASE_ARGTYPES = {
    "blend_fwd": [_P, ctypes.c_longlong, _P, _P, _P, _I, _I, _I, _F, _F, _F,
                  _P, _P, _P, _P, _P],
    "blend_bwd": [_P, ctypes.c_longlong, _P, _P, _P, _I, _I, _I, _F, _F, _P,
                  _P, _P, _P, _P, _P, _P],
}
KERNEL_FUNCS = {"K1": "blend_fwd_kernel", "K2": "blend_bwd_kernel"}
REPS = 20
TRAINED_STEPS = 24


def baseline_kernels(csrc: Path) -> dict:
    """The baseline's K1 and K2 as functions with the wrappers'
    arguments."""
    fns = {}
    for name, argtypes in _BASE_ARGTYPES.items():
        lib = ctypes.CDLL(str(build_library(name, csrc)))
        lib.segs_cuda_error_string.argtypes = [ctypes.c_int]
        lib.segs_cuda_error_string.restype = ctypes.c_char_p
        fn = getattr(lib, f"segs_{name}")
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = (lib, fn)

    def fwd(feats, start, stop, bg, tiles_x, rc):
        lib, fn = fns["blend_fwd"]
        nt, npix = start.shape[0], rc.tile * rc.tile
        out = [torch.empty((nt, c, npix), dtype=dt, device=feats.device)
               for c, dt in ((3, torch.float32), (1, torch.float32),
                             (1, torch.float32), (1, torch.int32))]
        code = fn(feats.data_ptr(), feats.shape[1], start.data_ptr(),
                  stop.data_ptr(), bg.data_ptr(), nt, tiles_x, rc.tile,
                  rc.alpha_min, rc.alpha_clamp, rc.transmittance_min,
                  *(x.data_ptr() for x in out),
                  torch.cuda.current_stream().cuda_stream)
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
                                           ncontrib, dfeats)),
                  torch.cuda.current_stream().cuda_stream)
        check(lib, code, "baseline blend_bwd launch")
        return dfeats

    return {"K1": fwd, "K2": bwd}


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


def view_inputs(dev) -> list:
    """K2's arguments (K1's are the first six) on chip_smoke.py's 640x480
    kernel-phase view, with its seeded cotangents."""
    from segs_slam_tpu_torch.core import Camera, Keyframe
    from segs_slam_tpu_torch.io.convert import (
        anchors_from_numpy,
        decoders_from_jax,
        flatten_params,
    )
    from segs_slam_tpu_torch.models.config import ModelConfig
    from segs_slam_tpu_torch.models.renderer import project_view
    from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
    from segs_slam_tpu_torch.ops.rasterizer.binning import (
        compact_gaussians,
        expand_and_sort,
    )
    from segs_slam_tpu_torch.utils.synthetic import seeded_map

    mc = ModelConfig()
    anchors_np, dec_np = seeded_map(mc, n_active=2**15, seed=0)
    anchors = anchors_from_numpy(anchors_np, dev)
    decoders = decoders_from_jax(flatten_params(dec_np), dev)
    rc = RasterConfig(tile=16, compact=2**16, kmax=8, chunk=256, ksmall=4,
                      nlarge=2**13)
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
        b = expand_and_sort(compact_gaussians(feats, aux, rc), tx, ty, rc)
        args = (b.feats_sorted, b.tile_start, b.tile_stop, bg, tx, rc)
        _, final_t, _, ncontrib = blend.blend_forward_reference(*args)
    nt = tx * ty
    g = torch.Generator().manual_seed(2)
    cot = (torch.randn(nt, 3, 256, generator=g),
           0.1 * torch.randn(nt, 1, 256, generator=g),
           torch.randn(nt, 1, 256, generator=g))
    return [(*args, *(x.to(dev) for x in cot), final_t, ncontrib)]


def trained_inputs() -> list:
    """K2's arguments on TRAINED_STEPS steps of train_synthetic's map
    (full width, --freq-reg) after 300 iterations."""
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
    return captured


def check_variant(kernel: str, fn, inputs) -> dict:
    """The variant against the plain version on every input."""
    worst = {"nc_equal": 1.0, "err": 0.0}
    ok = True
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
                worst["nc_equal"] = min(worst["nc_equal"], share)
            else:
                got = fn(*a)
                ref = blend.blend_backward_reference(*a)
                scale = ref.abs().amax(dim=1).clamp(min=1e-30)
                err = float(((got - ref).abs().amax(dim=1) / scale).max())
                ok &= bool(torch.isfinite(got).all()) and err <= 1e-4
            worst["err"] = max(worst["err"], err)
    return dict(worst, ok=bool(ok))


def time_set(inputs, variants: dict) -> dict:
    """Each kernel's variants in turns: names in order, then reversed."""
    res = {}
    order = list(variants) + list(reversed(variants))
    for kernel in ("K1", "K2"):
        calls = {name: [(lambda f=f, a=a: f(*(a[:6] if kernel == "K1"
                                                else a)))
                        for a in inputs]
                 for name, f in ((n, v[kernel]) for n, v in variants.items())}
        runs = {name: [] for name in variants}
        with torch.inference_mode():
            for name in order:
                runs[name].append(device_ms(calls[name], KERNEL_FUNCS[kernel],
                                            reps=REPS))
            call_ms = {name: float(np.mean([event_ms(c, reps=5, warmup=1)
                                            for c in calls[name]]))
                       for name in variants}
        res[kernel] = {name: {"device_ms": float(np.mean(r)), "runs": r,
                              "call_ms": call_ms[name]}
                       for name, r in runs.items()}
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--baseline", type=Path, default=None,
                   help="another checkout's segs_slam_tpu_torch/csrc")
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("blend_ab needs a CUDA card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    variants = {}
    if args.baseline is not None:
        variants["baseline"] = baseline_kernels(args.baseline)
    for p_ in blend.KERNEL_PIXELS:
        variants[f"P{p_}"] = {
            "K1": at_pixels(blend.blend_forward_cuda, p_),
            "K2": at_pixels(blend.blend_backward_cuda, p_)}

    out = {"device": smi, "reps": REPS, "sets": {}}
    ok = True
    for set_name, make in (("640x480", lambda: view_inputs(dev)),
                           ("trained", trained_inputs)):
        inputs = make()
        checks = {f"{k} {name}": check_variant(k, v[k], inputs)
                  for name, v in variants.items() if name != "baseline"
                  for k in ("K1", "K2")}
        ok &= all(c["ok"] for c in checks.values())
        a = inputs[0]
        out["sets"][set_name] = {
            "inputs": len(inputs), "tiles": int(a[1].shape[0]),
            "instances_a_tile": tile_counts(
                torch.cat([x[1] for x in inputs]),
                torch.cat([x[2] for x in inputs])),
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
