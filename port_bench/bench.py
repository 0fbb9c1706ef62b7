"""One run of one cell: set-up, the measured window, the traced window's
per-layer metrics, and the comparison with the plain reference that
decides `correct`.

Everything that belongs to a configuration, a traffic mix, a metric or a
cell's limits is a file found by name: `configs/<config>.json`,
`traffic/<mix>.json`, `kinds/<kind>.py` (the code that runs the traffic's
`kind`), `end_to_end/<metric>.py` and `metrics/<metric>.py` (the readers
of the end-to-end and per-layer metrics), `limits/<workload>.json`.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from port_bench import trace, work

HERE = Path(__file__).resolve().parent
_MODULES: dict = {}


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def manifest() -> dict:
    return json.loads((HERE.parent / "BENCHMARK.json").read_text())


def load_module(folder: str, name: str):
    """The module `<folder>/<name>.py` of the benchmark, loaded once."""
    key = (folder, name)
    if key not in _MODULES:
        path = HERE / folder / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"port_bench.{folder}.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def load_metric(name: str):
    """The reader of per-layer metric `name` (metrics/<name>.py)."""
    return load_module("metrics", name)


def load_end_to_end(name: str):
    """The reader of end-to-end metric `name` (end_to_end/<name>.py)."""
    return load_module("end_to_end", name)


def load_kind(name: str):
    """The code that runs traffic kind `name` (kinds/<name>.py): its
    `Inputs`, its `Cell`, `traced` and `control`."""
    return load_module("kinds", name)


def cell(workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, config, traffic) of a workload named in
    BENCHMARK.json."""
    for w in manifest()["workloads"]:
        if w["name"] == workload:
            return w, load_json("configs", w["config"]), load_json(
                "traffic", w["traffic"])
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(workload: str, trace_on: bool) -> list[str]:
    """The metric names a run of `workload` reports: its end-to-end metrics
    (trace 0) or its per-layer metrics (trace 1)."""
    m = manifest()
    out = []
    for entry in m["per_layer" if trace_on else "end_to_end"]:
        if workload in entry.get("workloads", [workload]):
            out.append(entry["name"])
    return out


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def program_configs(cfg: dict, radius: float | None = None):
    """The port's ModelConfig, OptimizationConfig, RasterConfig and
    MapperConfig as the configuration file states them."""
    from segs_slam_tpu_torch.models.config import ModelConfig
    from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
    from segs_slam_tpu_torch.slam.mapper import MapperConfig
    from segs_slam_tpu_torch.train.config import OptimizationConfig

    oc = dict(cfg["optimization"])
    if radius is not None:
        oc["spatial_lr_scale"] = radius
    return (ModelConfig(**cfg["model"]), OptimizationConfig(**oc),
            RasterConfig(**cfg["raster"]), MapperConfig(**cfg["mapper"]))


def reference_raster(cfg: dict) -> dict:
    """The configuration's raster settings as the reference reads them (no
    eval tiers unless the eval path adds them)."""
    return {"kmid": 0, "nmid": 0, **cfg["raster"]}


def program_state(anchors: dict, decoders: dict, mc, dev):
    """The port's AnchorState and Decoders holding copies of the harness's
    map and weights."""
    from segs_slam_tpu_torch.models.anchors import AnchorState
    from segs_slam_tpu_torch.models.decoders import Decoders

    state = AnchorState(**{k: v.clone() for k, v in anchors.items()})
    dec = Decoders(mc, generator=torch.Generator(device=dev).manual_seed(0),
                   device=dev)
    with torch.no_grad():
        for name, p in dec.named_parameters():
            p.copy_(decoders[name])
    return state, dec


class Counters:
    """The port's own counters, read before and after: the blend kernels'
    launches and the training blends by binning."""

    def __init__(self):
        from segs_slam_tpu_torch.ops.rasterizer import blend

        self.blend = blend

    def read(self) -> dict:
        b = self.blend
        return {"K1": b.blend_forward_cuda.launches,
                "K2": b.blend_backward_cuda.launches,
                "K3": b.blend_forward_eval_packed_cuda.launches,
                "K4": b.blend_forward_eval_cuda.launches,
                "train_binnings.f32": b.train_binnings["f32"],
                "train_binnings.packed": b.train_binnings["packed"]}


class Capture:
    """Wraps the blend dispatchers and the decode entry of the port's
    modules while `on`: keeps every `every`-th binned view's arguments and
    visible-anchor mask, for the work counts of the traced window. The
    wrappers only keep references, so they add no device work; the masks
    are counted once the window has closed."""

    def __init__(self, every: int = 1):
        from segs_slam_tpu_torch.models import renderer
        from segs_slam_tpu_torch.ops.rasterizer import blend

        self.on, self.every = False, every
        self.fwd, self.eval_packed, self.masks = [], [], []
        self.calls = {"fwd": 0, "eval_packed": 0, "decode": 0}
        self._mods = (blend, renderer)
        self._saved = (blend.blend_forward, blend.blend_forward_eval_packed,
                       renderer.neural_gaussians_for_view)
        fwd, evp, ngv = self._saved
        cap = self

        def blend_forward(feats, tile_start, tile_stop, bg, tiles_x, config):
            out = fwd(feats, tile_start, tile_stop, bg, tiles_x, config)
            if cap.keep("fwd"):
                cap.fwd.append((feats.detach(), tile_start, tile_stop,
                                tiles_x, config))
            return out

        def blend_forward_eval_packed(cols, tile_start, tile_stop, bg,
                                      tiles_x, config):
            out = evp(cols, tile_start, tile_stop, bg, tiles_x, config)
            if cap.keep("eval_packed"):
                cap.eval_packed.append((cols, tile_start, tile_stop, tiles_x,
                                        config))
            return out

        def neural_gaussians_for_view(*args, **kw):
            visible, neural = ngv(*args, **kw)
            if cap.keep("decode"):
                cap.masks.append(visible)
            return visible, neural

        blend.blend_forward = blend_forward
        blend.blend_forward_eval_packed = blend_forward_eval_packed
        renderer.neural_gaussians_for_view = neural_gaussians_for_view

    def keep(self, what: str) -> bool:
        """Whether this call of `what` is one of the kept ones."""
        if not self.on:
            return False
        n = self.calls[what]
        self.calls[what] = n + 1
        return n % self.every == 0

    def close(self):
        blend, renderer = self._mods
        (blend.blend_forward, blend.blend_forward_eval_packed,
         renderer.neural_gaussians_for_view) = self._saved

    def visible(self) -> list[int]:
        """The visible anchors of each kept decode."""
        return [int(m.sum()) for m in self.masks]

    def views(self) -> list[dict]:
        """Each kept binned view's pair counts and instance count (the
        eval kernel's packed columns decoded to f32 rows first)."""
        out = []
        for kind, (x, start, stop, tx, rc) in (
                [("f32", v) for v in self.fwd]
                + [("packed", v) for v in self.eval_packed]):
            rows = x if kind == "f32" else work.decode_columns(x, rc.pack8)
            pairs = work.pair_counts(rows, start, stop, tx, rc.tile,
                                     rc.alpha_min, rc.alpha_clamp,
                                     rc.transmittance_min,
                                     tile_local=kind == "packed")
            out.append({"kind": kind, "pairs": pairs, "start": start,
                        "nk": x.shape[1], "n": int((stop - start).sum()),
                        "npix": rc.tile * rc.tile})
        return out


def run_cell(workload: str, seed: int, seconds: float, trace_on: bool,
             dev: torch.device, cfg: dict | None = None,
             traffic: dict | None = None, limits: dict | None = None,
             log=print) -> dict:
    """One run of `workload`; returns the result line's object (with the
    compared numbers under `checks`, last) and logs the path line."""
    _entry, cfg0, traffic0 = cell(workload)
    cfg = cfg or cfg0
    traffic = traffic or traffic0
    limits = limits if limits is not None else load_json("limits", workload)
    kind = load_kind(traffic["kind"])
    if trace_on:
        traffic = kind.traced(traffic)
    t_setup = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    counters = Counters()
    capture = Capture(traffic.get("capture_every", 1)) if trace_on else None
    try:
        c = kind.Cell(kind.Inputs(cfg, traffic, seed, dev), trace_on)
        c.setup()
        setup_s = time.perf_counter() - t_setup
        before = counters.read()
        if trace_on:
            # the traced window runs its units whatever the clock says
            capture.on = True
            with trace.Window(dev) as tw:
                units, window_s = c.window(math.inf, traffic["trace_units"])
            capture.on = False
        else:
            units, window_s = c.window(seconds)
        after = counters.read()
        peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                else 0)
        ctx = {"workload": workload, "config": cfg, "traffic": traffic,
               "units": units, "window_s": window_s, "setup_s": setup_s,
               **c.readings()}
        if trace_on:
            ctx["trace"] = summary = tw.summary()
            ctx["views"] = capture.views()
            ctx["visible"] = capture.visible()
    finally:
        if capture is not None:
            capture.close()
    launched = {k: after[k] - before[k] for k in after}
    log(f"[path] {workload}: {json.dumps(c.path())}; counters over the "
        f"window {json.dumps(launched)}", flush=True)
    if trace_on:
        log(f"[trace] {summary['launches']} runtime launches, "
            f"{summary['kernels']} kernel records "
            f"({100.0 * summary['kernels'] / max(summary['launches'], 1):.2f}"
            f" % kept by the profiler), read in {summary['read_s']:.3f} s",
            flush=True)
    metrics = {}
    for name in cell_metrics(workload, trace_on):
        reader = load_metric(name) if trace_on else load_end_to_end(name)
        value = reader.read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit_of(name)}
    c.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checked = c.check()
    failed = checked.get("nonfinite", 0)
    checks = {k: {"value": v, "limit": limits["limits"][k]["limit"]}
              for k, v in checked["numbers"].items()}
    correct = (checked["same_inputs"] and all(
        math.isfinite(v["value"]) and v["value"] <= v["limit"]
        for v in checks.values()) and failed == 0)
    result = {"correct": bool(correct), "attempted": units, "failed": failed,
              "metrics": metrics, "device": device_info(dev, peak)}
    if trace_on:
        s = ctx["trace"]
        result["device"]["busy_s"] = s["busy_s"]
        result["device"]["window_s"] = s["window_s"]
        result["breakdown"] = {"device_ops": trace.top(s["device_by_name"]),
                               "idle_gaps": trace.top(s["idle_by_span"])}
    result["checks"] = checks
    result["_detail"] = checked["detail"]
    return result


def unit_of(name: str) -> str:
    m = manifest()
    for entry in m["end_to_end"] + m["per_layer"]:
        if entry["name"] == name:
            return entry["unit"]
    raise KeyError(name)


def device_info(dev: torch.device, peak: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def main_print(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    detail = result.pop("_detail")
    print(f"[check] {json.dumps(detail)}", file=err, flush=True)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=err,
              flush=True)
    print(json.dumps(result), file=out, flush=True)
