"""Kernel K5 (csrc/preprocess.cu) against its plain twin, the eager chain
compute_cov3d + preprocess_gaussians + blend_inputs, in one process on one
card, on EvalRenderer's views of a seeded full-width map at the sizes of
both benchmark configurations:

  tum_rgbd      640x480, fx = fy = 525, embedding_dim 200
  replica_rgbd  1200x680, fx = fy = 600, embedding_dim 179

each with 2^16 anchor slots x 10 offsets (655,360 gaussian slots), 2^15
anchors active (utils/synthetic.seeded_map), views on render_views' orbit
around them, and the apps' raster defaults calibrated on four of the views
(calibrate_eval_config).

    python -m segs_slam_tpu_torch.tools.preprocess_ab [--views 40] \\
        [--blocks 4] [--out FILE]

For each configuration:
  kernel    K5's two entries on the first view (the mask over the 65,536
            anchors, the full entry over the 655,360 gaussians): device ms
            (the mean duration torch.profiler records over 20+ launches),
            call ms (CUDA events around one wrapper call), the byte bound
            (42 B and 126 B a gaussian at 3.35 TB/s), the host ms of a call,
            and the eager chain's device ms, host ms and kernels a call;
  untraced  --blocks blocks of --views views a route, the routes
            alternating (the chain forced by replacing the route
            predicate), no profiler: the host ms a view of each part (the
            program's render.* spans timed on the host clock), of the image's
            copy to the host and of the whole view; medians over the blocks;
  traced    one block a route under torch.profiler, as the benchmark's
            traced runs record, alone and again holding every view's blend
            inputs and prefilter mask as the benchmark's traced window
            does: each span's host ms a view, the device's busy ms a view,
            the memory segments the caching allocator added, and inside the
            render.binning span the host's CUDA runtime calls by name (calls
            and ms a view), the host time outside them, and the device time
            that ran while it was open;
  images    every view's image through K5 and through the chain, bit for
            bit.
Prints one JSON line, also written to --out; exits 1 if an image or a K5
output differs from the chain's. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from segs_slam_tpu_torch.utils import tracing

# the module (the package exports a function of the same name)
rasterize = importlib.import_module(
    "segs_slam_tpu_torch.ops.rasterizer.rasterize")

# name: (width, height, focal length, embedding_dim)
CONFIGS = {"tum_rgbd": (640, 480, 525.0, 200),
           "replica_rgbd": (1200, 680, 600.0, 179)}
HBM_BYTES_PER_S = 3.35e12
# K5's bytes a gaussian: the mask entry reads xyz, scale and quaternion
# rows and the valid byte (41 B) and writes a byte; the full entry reads
# those and opacity and colour (57 B) and writes the nine blend rows,
# depth, seven int32 rows and the alive byte (69 B)
MASK_BYTES, FULL_BYTES = 42, 126
SPANS = ("render.prefilter", "render.decode", "render.project",
         "render.binning", "render.blend")


def seeded_scene(name: str, device, n_views: int, seed: int = 0):
    """The seeded map, its orbit cameras (render_inputs as tensors on
    `device`, tan_fov as 0-d tensors) and the calibrated EvalRenderer of
    configuration `name`."""
    from segs_slam_tpu_torch.apps.render_views import orbit_poses
    from segs_slam_tpu_torch.core import Camera, Keyframe
    from segs_slam_tpu_torch.io.convert import (
        anchors_from_numpy,
        decoders_from_jax,
        flatten_params,
    )
    from segs_slam_tpu_torch.models.config import ModelConfig
    from segs_slam_tpu_torch.models.renderer import (
        EvalRenderer,
        calibrate_eval_config,
    )
    from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
    from segs_slam_tpu_torch.utils.synthetic import seeded_map

    w, h, f, emb = CONFIGS[name]
    anchors, dec = seeded_map(ModelConfig(embedding_dim=emb), n_active=2**15,
                              seed=seed)
    state = anchors_from_numpy(anchors, device)
    decoders = decoders_from_jax(flatten_params(dec), device)
    mc = dataclasses.replace(decoders.config, capacity=state.capacity)
    camera = Camera(camera_id=0, width=w, height=h, fx=f, fy=f, cx=w / 2,
                    cy=h / 2)
    center = anchors["anchor"][anchors["active"]].mean(axis=0)
    cams = [{k: torch.as_tensor(v, device=device) for k, v in Keyframe(
                kf_id=i, camera=camera, quat=q, trans=t).render_inputs()
             .items()}
            for i, (q, t) in enumerate(orbit_poses(
                center, 1.5, -0.3, n_views, center + np.array([0, 0, 0.5])))]
    # the apps' raster defaults
    rc = RasterConfig(tile=16, compact=2**16, kmax=8, chunk=256, ksmall=4,
                      nlarge=2**13)
    rc = calibrate_eval_config(rc, mc, state, decoders,
                               cams[::max(1, n_views // 4)][:4], w, h)
    renderer = EvalRenderer(mc, rc, w, h, torch.zeros(3, device=device),
                            device=device)
    return SimpleNamespace(name=name, w=w, h=h, mc=mc, rc=rc, state=state,
                           decoders=decoders, cams=cams, renderer=renderer)


@contextlib.contextmanager
def chain_forced():
    """The eager chain on every preprocess call (the route predicate
    replaced) while open."""
    saved = rasterize.uses_preprocess_kernel
    rasterize.uses_preprocess_kernel = lambda *a, **k: False
    try:
        yield
    finally:
        rasterize.uses_preprocess_kernel = saved


@contextlib.contextmanager
def host_spans():
    """The program's spans timed on the host clock, without a profiler:
    yields {name: ms} summed over the calls while open."""
    ms: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def span(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ms[name] += (time.perf_counter() - t0) * 1e3

    saved = tracing.span
    tracing.span = span
    try:
        yield ms
    finally:
        tracing.span = saved


def same_bits(got: torch.Tensor, ref: torch.Tensor) -> int:
    """Elements of `got` whose bits differ from `ref`'s (NaN matches NaN);
    every element if the shapes or types differ."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        return max(got.numel(), ref.numel())
    if got.is_floating_point():
        g, r = got.contiguous(), ref.contiguous()
        same = (g.view(torch.int32) == r.view(torch.int32)) | (
            torch.isnan(g) & torch.isnan(r))
    else:
        same = got == ref
    return int((~same).sum())


def k5_inputs(scene, cam):
    """(mask entry's arguments, full entry's arguments) of one view, as
    EvalRenderer gives them to visible_filter and project."""
    from segs_slam_tpu_torch.models.renderer import neural_gaussians_for_view

    s, w, h, rc = scene.state, scene.w, scene.h, scene.rc
    camera = (cam["world_view_transform"], cam["full_proj_transform"], w, h,
              cam["tan_fovx"], cam["tan_fovy"], rc)
    with torch.no_grad():
        rotation = s.rotation / torch.clamp(
            torch.linalg.norm(s.rotation, dim=-1, keepdim=True), min=1e-12)
        mask = (s.anchor, torch.exp(s.scaling[:, :3]), rotation, *camera,
                s.active)
        ng = neural_gaussians_for_view(s, scene.decoders, cam, w, h,
                                       scene.mc, rc)[1]
    full = (ng.xyz, ng.scaling, ng.rotation, *camera, ng.valid, ng.opacity,
            ng.color)
    return mask, full


def chain(args):
    """The eager chain on K5's arguments: the mask radius > 0 (mask
    entry's) or (GaussianProjection, feats, aux) (full entry's)."""
    from segs_slam_tpu_torch.ops.rasterizer.preprocess import (
        compute_cov3d,
        preprocess_gaussians,
    )

    means, scales, quats, wvt, fpt, w, h, tx, ty, rc, valid = args[:11]
    with torch.no_grad():
        proj = preprocess_gaussians(means, compute_cov3d(scales, quats),
                                    wvt, fpt, w, h, tx, ty, rc,
                                    valid_in=valid)
        if len(args) == 11:
            return proj.radius > 0
        return (proj, *rasterize.blend_inputs(proj, *args[11:13]))


def k5_differences(mask_args, full_args) -> dict:
    """Elements of each K5 output that differ from the chain's."""
    with torch.no_grad():
        mask = rasterize.preprocess_cuda(*mask_args)
        proj, feats, aux = rasterize.preprocess_cuda(*full_args)
    ref_proj, ref_feats, ref_aux = chain(full_args)
    diff = {"mask": same_bits(mask, chain(mask_args)),
            "feats": same_bits(feats, ref_feats)}
    for field in proj._fields:
        diff[field] = same_bits(getattr(proj, field),
                                getattr(ref_proj, field))
    for key in ref_aux:
        diff[f"aux.{key}"] = (same_bits(aux[key], ref_aux[key])
                              if key in aux else -1)
    return diff


def _host_ms(fn, reps: int = 20) -> float:
    """Median host time of one fn() call issued onto an idle device."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def _chain_device(fn, reps: int = 10) -> tuple[float, float]:
    """(device ms, device operations) a call of fn, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return (sum(e.time_range.elapsed_us() for e in ops) / 1e3 / reps,
            len(ops) / reps)


def k5_numbers(mask_args, full_args) -> dict:
    """Each entry's device ms, call ms, byte bound, host ms and the eager
    chain's device ms, device operations and host ms, on one view."""
    from segs_slam_tpu_torch.utils.kernel_timing import device_ms, event_ms

    out = {}
    with torch.no_grad():
        for entry, args, per in (("mask", mask_args, MASK_BYTES),
                                 ("full", full_args, FULL_BYTES)):
            def k5(args=args):
                return rasterize.preprocess_cuda(*args)

            def plain(args=args):
                return chain(args)

            n = args[0].shape[0]
            kernel = ("preprocess_kernel<true>" if entry == "full"
                      else "preprocess_kernel<false>")
            dev_ms, ops = _chain_device(plain)
            out[entry] = {
                "gaussians": n, "ms": device_ms([k5], kernel),
                "call_ms": event_ms(k5, 20, 3), "host_ms": _host_ms(k5),
                "bound_ms": n * per / HBM_BYTES_PER_S * 1e3,
                "chain": {"device_ms": dev_ms, "device_ops": ops,
                          "host_ms": _host_ms(plain)}}
    return out


def _view(scene, cam, ms):
    """One view to its image on the host; adds the whole view's and the
    copy's host ms to `ms`."""
    t0 = time.perf_counter()
    img = scene.renderer(scene.state, scene.decoders, cam)
    t1 = time.perf_counter()
    img = img.cpu()
    t2 = time.perf_counter()
    ms["to_host"] += (t2 - t1) * 1e3
    ms["view"] += (t2 - t0) * 1e3
    return img


def untraced(scene, blocks: int) -> dict:
    """Median over blocks of each part's host ms a view, a route."""
    per_block = {"kernel": [], "chain": []}
    for b in range(blocks):
        for route in (("kernel", "chain") if b % 2 == 0
                      else ("chain", "kernel")):
            forced = chain_forced() if route == "chain" else \
                contextlib.nullcontext()
            with forced, host_spans() as ms:
                for cam in scene.cams:
                    _view(scene, cam, ms)
            n = len(scene.cams)
            parts = {k: v / n for k, v in ms.items()}
            parts["rest"] = parts["view"] - parts["to_host"] - sum(
                parts.get(s, 0.0) for s in SPANS)
            per_block[route].append(parts)
    return {route: {k: statistics.median(p[k] for p in rows)
                    for k in rows[0]} for route, rows in per_block.items()}


@contextlib.contextmanager
def holding():
    """While open, a reference to every view's blend inputs and prefilter
    mask is kept, as the benchmark's traced window keeps them for its work
    counts, so the caching allocator cannot reuse their memory."""
    import segs_slam_tpu_torch.models.renderer as renderer
    import segs_slam_tpu_torch.ops.rasterizer.blend as blend

    held = []
    saved = (blend.blend_forward, blend.blend_forward_eval_packed,
             renderer.neural_gaussians_for_view)

    def keeping(fn):
        def wrapper(*args, **kw):
            out = fn(*args, **kw)
            held.append(out[0] if fn is saved[2] else args)
            return out
        return wrapper

    (blend.blend_forward, blend.blend_forward_eval_packed,
     renderer.neural_gaussians_for_view) = map(keeping, saved)
    try:
        yield held
    finally:
        (blend.blend_forward, blend.blend_forward_eval_packed,
         renderer.neural_gaussians_for_view) = saved


def traced(scene) -> dict:
    """Each route's block under torch.profiler, alone and holding every
    view's blend inputs (`holding`): spans, busy device time, what the
    host does inside render.binning, and the device memory segments the
    caching allocator added."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    n = len(scene.cams)
    for route in ("kernel", "chain", "kernel_held", "chain_held"):
        forced = chain_forced() if route.startswith("chain") else \
            contextlib.nullcontext()
        held = holding() if route.endswith("held") else \
            contextlib.nullcontext()
        tracing.reset()
        torch.cuda.synchronize()
        segments = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        ms: dict[str, float] = defaultdict(float)
        with forced, held, profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for cam in scene.cams:
                _view(scene, cam, ms)
        segments = torch.cuda.memory_stats().get(
            "segment.all.allocated", 0) - segments
        spans = tracing.read()["spans"]
        tracing.reset()
        events = []
        for e in prof.profiler.kineto_results.events():
            a = e.start_ns() / 1e3
            events.append((e.name(), e.device_type() != DeviceType.CPU, a,
                           a + e.duration_ns() / 1e3,
                           e.is_user_annotation()))
        dev = sorted((a, b) for name, on_dev, a, b, ann in events
                     if on_dev and not ann
                     and not name.startswith(("render.", "bench.")))
        bins = [(a, b) for name, on_dev, a, b, _ in events
                if not on_dev and name == "render.binning"]
        calls: dict[str, list] = defaultdict(lambda: [0, 0.0])
        in_calls = dev_in = 0.0
        for a, b in bins:
            for name, on_dev, c, d, _ in events:
                if not on_dev and name.startswith("cu") and a <= c \
                        and d <= b:
                    calls[name][0] += 1
                    calls[name][1] += (d - c) / 1e3
                    in_calls += (d - c) / 1e3
            dev_in += sum(min(d, b) - max(c, a) for c, d in dev
                          if c < b and d > a) / 1e3
        bin_ms = sum(b - a for a, b in bins) / 1e3
        top = sorted(calls.items(), key=lambda kv: -kv[1][1])[:8]
        out[route] = {
            "view_ms": ms["view"] / n, "to_host_ms": ms["to_host"] / n,
            "spans_ms": {k: v["s"] * 1e3 / n for k, v in spans.items()},
            "device_ms": sum(b - a for a, b in dev) / 1e3 / n,
            "segments_added": segments,
            "binning": {
                "ms": bin_ms / n,
                "runtime_calls": {k: [c / n, t / n] for k, (c, t) in top},
                "runtime_ms": in_calls / n,
                "outside_runtime_ms": (bin_ms - in_calls) / n,
                "device_ms_while_open": dev_in / n}}
    return out


def images_equal(scene) -> tuple[int, int]:
    """(views whose images differ between the routes, K5 launches a
    view)."""
    launches = rasterize.preprocess_cuda.launches
    with torch.no_grad():
        k5 = [scene.renderer(scene.state, scene.decoders, c)
              for c in scene.cams]
    per_view = (rasterize.preprocess_cuda.launches - launches) / len(k5)
    with chain_forced(), torch.no_grad():
        plain = [scene.renderer(scene.state, scene.decoders, c)
                 for c in scene.cams]
    return sum(not torch.equal(a, b) for a, b in zip(k5, plain)), per_view


def run(name: str, views: int, blocks: int) -> dict:
    dev = torch.device("cuda")
    scene = seeded_scene(name, dev, views)
    mask_args, full_args = k5_inputs(scene, scene.cams[0])
    res = {"size": [scene.w, scene.h],
           "differences": k5_differences(mask_args, full_args),
           "kernel": k5_numbers(mask_args, full_args)}
    res["images_differ"], res["k5_launches_a_view"] = images_equal(scene)
    res["untraced"] = untraced(scene, blocks)
    res["traced"] = traced(scene)
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--views", type=int, default=40)
    p.add_argument("--blocks", type=int, default=4)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    res = {"card": smi.stdout.strip(),
           "configs": {name: run(name, args.views, args.blocks)
                       for name in CONFIGS}}
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    bad = [name for name, r in res["configs"].items()
           if r["images_differ"] or any(r["differences"].values())]
    if bad:
        print(f"preprocess_ab: K5 differs from the chain in {bad}",
              file=sys.stderr, flush=True)
        sys.exit(1)
    return res


if __name__ == "__main__":
    main()
