"""Traffic kind "render": one closed-loop client of the eval render. The
sequence's frame poses in order, cycled, each view's image copied to the
host; the EvalRenderer is calibrated in set-up as Trainer.eval_renderer
does.

Traffic keys: keyframe_every (the keyframes whose views calibrate the eval
tiers and whose surfaces carry the map), warmup_views, trace_units,
sample_views and sample_within (the compared window positions, drawn from
the seed).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from port_bench import bench, reference, scene, trace


class Inputs:
    """The inputs from the seed: the sequence's frame poses, the map seeded
    on the surfaces the keyframes see and its decoders, the calibration
    views (up to four of the keyframes, as Trainer.eval_renderer takes
    them) and the window positions whose images are compared."""

    def __init__(self, cfg, traffic, seed, dev):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, dev
        cam = cfg["camera"]
        self.w, self.h = cam["width"], cam["height"]
        self.poses = scene.trajectory(cfg["sequence"]["frames"])
        self.cams = scene.camera_inputs(self.poses, cam, dev)
        kfs = list(range(0, len(self.poses), traffic["keyframe_every"]))
        self.anchors, self.decoders = scene.seeded_scene(
            cfg, [self.poses[i] for i in kfs], seed, dev)
        self.calib = kfs[::max(1, len(kfs) // 4)][:4]
        rng = np.random.default_rng(seed)
        self.sample_at = sorted(int(i) for i in rng.choice(
            traffic["sample_within"], traffic["sample_views"], replace=False))

    def cam(self, i: int) -> dict:
        return scene.view(self.cams, i % len(self.poses))

    def reference(self, positions, precision: str = "f32") -> dict:
        """The reference's image of each window position's pose."""
        cfg = self.cfg
        rc, eval_path = reference.eval_config(bench.reference_raster(cfg),
                                              self.w, self.h)
        if eval_path:
            rc = reference.calibrate(
                self.anchors, self.decoders,
                [self.cam(i) for i in self.calib], cfg["model"], rc, self.w,
                self.h)
        return {i: reference.eval_image(
            self.anchors, self.decoders, self.cam(i), cfg["model"], rc,
            self.w, self.h, eval_path, precision) for i in positions}


def traced(traffic: dict) -> dict:
    """The compared positions lie inside the shorter traced window."""
    return dict(traffic, sample_within=min(traffic["sample_within"],
                                           traffic["trace_units"]))


def control(x: Inputs, precision: str) -> dict:
    """The compared number with the reference in `precision` in the
    program's place."""
    return compare_images(x.reference(x.sample_at, precision),
                          x.reference(x.sample_at))


def compare_images(prog: dict, ref: dict) -> dict:
    """The compared number: the mean absolute difference of the compared
    views' images, averaged over the views."""
    errs, worst, nonfinite = [], 0.0, 0
    for i, img in prog.items():
        got = img.to(ref[i].device)
        nonfinite += int(not torch.isfinite(got).all())
        d = (got - ref[i]).abs()
        errs.append(float(d.mean()))
        worst = max(worst, float(d.max()))
    return {"numbers": {"image_mae": float(np.mean(errs)) if errs
                        else math.inf},
            "same_inputs": True, "nonfinite": nonfinite,
            "detail": {"views_compared": len(errs), "image_max": worst}}


class Cell:
    """The production EvalRenderer over the inputs' map, one view at a
    time."""

    def __init__(self, inputs: Inputs, trace_on: bool):
        from segs_slam_tpu_torch.models.renderer import (
            EvalRenderer,
            calibrate_eval_config,
        )

        self.inputs, self.trace_on = inputs, trace_on
        x, dev = inputs, inputs.dev
        self.traffic = x.traffic
        mc, _oc, rc, _mpc = bench.program_configs(x.cfg)
        self.mc = mc
        self.state, self.dec = bench.program_state(x.anchors, x.decoders, mc,
                                                   dev)
        rc_eval = calibrate_eval_config(
            rc, mc, self.state, self.dec, [x.cam(i) for i in x.calib], x.w,
            x.h)
        self.renderer = EvalRenderer(mc, rc_eval, x.w, x.h,
                                     torch.zeros(3, device=dev), device=dev)
        self.rc_eval = rc_eval
        self.sample_at = set(x.sample_at)
        self.kept: dict[int, torch.Tensor] = {}
        self.times: list[float] = []
        self.compact_seen: list = []
        counts = self.renderer.render_with_counts
        cellf = self

        def render_with_counts(*a, **kw):
            out = counts(*a, **kw)
            cellf.last_counts = out
            cellf.compact_seen.append(out["num_compact"])
            return out
        self.renderer.render_with_counts = render_with_counts
        self.next = 0

    def setup(self):
        for _ in range(self.traffic["warmup_views"]):
            self._view(keep=False)
        self.next = 0
        bench.sync(self.inputs.dev)

    def compared_run(self):
        """A short window at the cell's load that reaches every compared
        position."""
        self.window(math.inf, self.traffic["sample_within"])

    def _view(self, keep=True):
        i = self.next
        span = trace.spans(self.trace_on)
        t0 = time.perf_counter()
        with span("bench.view"):
            img = self.renderer(self.state, self.dec, self.inputs.cam(i))
        with span("bench.to_host"):
            host = img.cpu()
        t1 = time.perf_counter()
        if keep:
            self.times.append(t1 - t0)
            if i in self.sample_at:
                self.kept[i] = host
        self.next += 1
        return t1

    def window(self, seconds: float, max_units: int | None = None):
        self.times.clear()
        self.compact_seen.clear()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        n = 0
        while True:
            t1 = self._view()
            n += 1
            if t1 >= deadline or (max_units is not None and n >= max_units):
                break
        bench.sync(self.inputs.dev)
        return n, time.perf_counter() - t0

    def readings(self) -> dict:
        return {"times": list(self.times)}

    def path(self) -> dict:
        m = self.last_counts
        rc = self.rc_eval
        return {"num_compact": int(m["num_compact"]),
                "num_compact_max": max(int(v) for v in self.compact_seen),
                "compact": rc.compact,
                "num_kmax_truncated": int(m["num_kmax_truncated"]),
                "kmax": rc.kmax, "n_active": int(self.state.num_active()),
                "capacity": self.mc.capacity,
                "num_instances": int(m["num_instances"]),
                "max_instances": rc.max_instances,
                "packed": self.renderer.packed, "nmid": rc.nmid,
                "nlarge": rc.nlarge}

    def release(self):
        self.program = dict(self.kept)
        del self.renderer, self.state, self.dec, self.last_counts
        self.compact_seen = []

    def check(self) -> dict:
        return compare_images(self.program,
                              self.inputs.reference(sorted(self.program)))
