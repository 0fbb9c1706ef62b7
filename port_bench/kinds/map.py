"""Traffic kind "map": the mapper after tracking. Every keyframe is in the
scene, the producer has finished, the queue is empty and the map is resumed
at an iteration of the densification and frequency-loss window. The first
`compared_steps` iterations run through Mapper.run in set-up and are held
to the reference; the window drives Mapper.run until it is aborted.

Traffic keys: keyframe_every, start_iteration, compared_steps,
warmup_iterations, trace_units (a whole densification interval, so that the
traced window holds one adjust), capture_every (the traced iterations
whose binned views the work counts read), resumed_stats.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from port_bench import bench, reference, scene, trace


class Inputs:
    """The inputs from the seed: the keyframes (every keyframe_every-th
    frame pose of the sequence, their RGB and depth), the map seeded on
    the surfaces they see, the decoders and resumed densification
    statistics."""

    def __init__(self, cfg, traffic, seed, dev):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, dev
        cam = cfg["camera"]
        self.w, self.h = cam["width"], cam["height"]
        poses = scene.trajectory(cfg["sequence"]["frames"])
        self.kf_poses = poses[::traffic["keyframe_every"]]
        self.radius = scene.nerfpp_radius(self.kf_poses)
        self.rgb, self.depth = scene.keyframe_images(self.kf_poses, cam, seed,
                                                     dev)
        self.anchors, self.decoders = scene.seeded_scene(
            cfg, self.kf_poses, seed, dev)
        self.stats = scene.seeded_stats(cfg["model"], self.anchors["active"],
                                        traffic["resumed_stats"], seed, dev)

    def initial(self) -> dict:
        out = {("anchors", n): v for n, v in self.anchors.items()
               if n != "active"}
        out.update({("decoders", n): v for n, v in self.decoders.items()})
        return out

    def reference(self, precision: str = "f32") -> dict:
        """The reference's compared steps from the same inputs."""
        cfg, tr = self.cfg, self.traffic
        stacked = scene.camera_inputs(self.kf_poses, cfg["camera"], self.dev)
        n = len(self.kf_poses)
        cams = [scene.view(stacked, i) for i in range(n)]
        gts = [torch.as_tensor(self.rgb[i], device=self.dev) for i in range(n)]
        oc = dict(cfg["optimization"], spatial_lr_scale=self.radius)
        sampled, losses, first, final = reference.train_steps(
            self.anchors, self.decoders, self.stats, cams, gts, list(range(n)),
            tr["start_iteration"], tr["compared_steps"], cfg["model"], oc,
            bench.reference_raster(cfg), self.w, self.h, self.seed,
            cfg["mapper"]["new_keyframe_times_of_use"], precision)
        return {"sampled": sampled, "losses": losses, "first": first,
                "final": final}


def traced(traffic: dict) -> dict:
    return traffic


def control(x: Inputs, precision: str) -> dict:
    """The compared numbers with the reference in `precision` in the
    program's place."""
    return compare_steps(x.reference(precision), x.reference(), x.initial())


class Cell:
    """Mapper.run over the inputs, resumed at start_iteration."""

    def __init__(self, inputs: Inputs, trace_on: bool):
        from segs_slam_tpu_torch.core.camera import Camera
        from segs_slam_tpu_torch.core.keyframe import Keyframe
        from segs_slam_tpu_torch.slam.mapper import Mapper
        from segs_slam_tpu_torch.slam.protocol import MappingQueue
        from segs_slam_tpu_torch.train.step import (
            DensifyStats,
            init_train_state,
        )
        from segs_slam_tpu_torch.train.trainer import Trainer

        self.inputs, self.trace_on = inputs, trace_on
        x, cfg, dev = inputs, inputs.cfg, inputs.dev
        self.traffic = x.traffic
        cam = cfg["camera"]
        mc, oc, rc, mpc = bench.program_configs(cfg, x.radius)
        self.mc = mc
        camera = Camera(0, x.w, x.h, cam["fx"], cam["fy"], cam["cx"],
                        cam["cy"])
        t = Trainer(mc, oc, rc, x.w, x.h, seed=x.seed,
                    keyframe_times_of_use=mpc.new_keyframe_times_of_use,
                    device=str(dev))
        for i, (q, tr) in enumerate(x.kf_poses):
            t.add_keyframe(Keyframe(kf_id=i, camera=camera, quat=q, trans=tr,
                                    image=x.rgb[i], depth=x.depth[i]))
        anchors, dec = bench.program_state(x.anchors, x.decoders, mc, dev)
        t.state = init_train_state(anchors, dec, mc)
        t.state.stats = DensifyStats(**{k: v.clone()
                                        for k, v in x.stats.items()})
        t.iteration = t.state.step = x.traffic["start_iteration"]
        # the per-keyframe camera and ground-truth caches filled, as in a
        # run at that iteration
        for kf in t.scene.keyframes.values():
            t._kf_inputs(kf)
        self.trainer = t
        self.mapper = Mapper(MappingQueue(), t, camera, mpc)
        self.mapper.initialized = True
        self.mapper.signal_stop()
        self._wrap()

    def _wrap(self):
        """Instance wrappers: the host span of each train_iteration, the
        keyframe each samples, and, while `self.watch` is set, its metrics
        and the Adam state after the first."""
        t, cellf = self.trainer, self
        iterate = t.train_iteration
        sample = t.scene.sample_sliding_window_keyframe
        span = trace.spans(self.trace_on)
        self.spans, self.sampled, self.step_metrics = [], [], []
        self.compact_seen = []
        self.first_grads = None
        self.watch = True
        self.deadline = None
        self.count = 0

        def train_iteration():
            t0 = time.perf_counter()
            with span("bench.iteration"):
                m = iterate()
            t1 = time.perf_counter()
            cellf.spans.append(t1 - t0)
            cellf.count += 1
            cellf.last_metrics = m
            cellf.compact_seen.append(m["num_compact"])
            if cellf.watch:
                cellf.step_metrics.append(m)
                if cellf.first_grads is None:
                    cellf.first_grads = _adam_grads(t.state.adam)
            if cellf.deadline is not None and t1 >= cellf.deadline:
                cellf.mapper.abort()
            return m

        def sample_keyframe():
            kf = sample()
            if cellf.watch and kf is not None:
                cellf.sampled.append(kf.kf_id)
            return kf

        t.train_iteration = train_iteration
        t.scene.sample_sliding_window_keyframe = sample_keyframe

    def setup(self):
        n = self.traffic["compared_steps"]
        start = self.traffic["start_iteration"]
        self.mapper.run(max_iterations=start + n)
        self.final = _params(self.trainer.state)
        self.watch = False
        self.mapper.run(max_iterations=start + n
                        + self.traffic["warmup_iterations"])
        bench.sync(self.inputs.dev)

    def compared_run(self):
        """The runs the compared outputs need beyond set-up: none."""

    def window(self, seconds: float, max_units: int | None = None):
        """Mapper.run until `seconds` have passed (or max_units
        iterations); returns (units, window seconds)."""
        self.spans.clear()
        self.compact_seen.clear()
        self.count = 0
        self.mapper.stopped = False
        t0 = time.perf_counter()
        self.deadline = t0 + seconds
        limit = (None if max_units is None
                 else self.trainer.iteration + max_units)
        self.mapper.run(max_iterations=limit)
        bench.sync(self.inputs.dev)
        dt = time.perf_counter() - t0
        self.deadline = None
        return self.count, dt

    def readings(self) -> dict:
        return {"spans": list(self.spans)}

    def path(self) -> dict:
        m = self.last_metrics
        rc = self.trainer.raster_config
        return {"num_compact": int(m["num_compact"]),
                "num_compact_max": max(int(v) for v in self.compact_seen),
                "compact": rc.compact,
                "num_kmax_truncated": int(m["num_kmax_truncated"]),
                "kmax": rc.kmax, "n_active": int(m["n_active"]),
                "capacity": self.mc.capacity,
                "num_instances": int(m["num_instances"]),
                "max_instances": rc.max_instances,
                "iteration": self.trainer.iteration}

    def release(self):
        """The program's compared outputs kept; the rest of its state
        freed."""
        self.program = {"sampled": self.sampled,
                        "losses": [float(m["loss"]) for m in
                                   self.step_metrics],
                        "first": self.first_grads, "final": self.final}
        del self.trainer, self.mapper, self.step_metrics, self.last_metrics
        self.compact_seen = []

    def check(self) -> dict:
        return compare_steps(self.program, self.inputs.reference(),
                             self.inputs.initial())


def _adam_grads(adam) -> dict:
    """The gradient each leaf's first Adam step received, from its first
    moment: m1 = (1 - b1) g."""
    out = {}
    for group in ("anchors", "decoders"):
        for name, mu in adam.mu[group].items():
            out[(group, name)] = (mu / (1 - 0.9)).clone()
    return out


def _params(ts) -> dict:
    out = {("anchors", n): v.detach().clone()
           for n, v in ts.anchors.params().items()}
    out.update({("decoders", n): p.detach().clone()
                for n, p in ts.decoders.named_parameters()})
    out[("anchors", "active")] = ts.anchors.active.clone()
    return out


def _widest_gap(prog: dict, ref: dict, keep) -> tuple[float, str]:
    """max over leaves of |norm(prog) - norm(ref)| / max(norm(ref), the
    median leaf's norm), over the leaves `keep` names."""
    norms = {p: float(torch.linalg.norm(ref[p].double())) for p in keep}
    med = statistics.median(norms.values())
    worst, leaf = 0.0, ""
    for p in keep:
        gap = abs(float(torch.linalg.norm(prog[p].double())) - norms[p]) \
            / max(norms[p], med, 1e-30)
        if gap > worst:
            worst, leaf = gap, ".".join(p)
    return worst, leaf


def compare_steps(prog: dict, ref: dict, init: dict) -> dict:
    """The compared numbers: the relative gap of the first step's loss, and
    the widest relative gap, by leaf, of the first gradient's norms and of
    the norms of the parameters' change over the compared steps."""
    ref_g = {p: float(torch.linalg.norm(g.double()))
             for p, g in ref["first"].items()}
    med = statistics.median(ref_g.values())
    # leaves whose gradient is nought to rounding in the reference (under a
    # thousandth of the median leaf's) move by round-off alone
    keep = [p for p, n in ref_g.items() if n >= 1e-3 * med]
    d_prog = {p: prog["final"][p] - init[p] for p in keep}
    d_ref = {p: ref["final"][p] - init[p] for p in keep}
    grad_gap, grad_leaf = _widest_gap(prog["first"], ref["first"], keep)
    change_gap, change_leaf = _widest_gap(d_prog, d_ref, keep)
    # the first step's loss only: from the second on, Adam's first update
    # has moved every element by its learning rate, also those whose
    # gradient is rounding, in either direction on the two sides
    if prog["losses"] and len(prog["losses"]) == len(ref["losses"]):
        a, b = prog["losses"][0], ref["losses"][0]
        first_loss_gap = abs(a - b) / abs(b)
    else:
        first_loss_gap = math.inf
    return {"numbers": {"first_loss_gap": first_loss_gap,
                        "grad_gap": grad_gap, "change_gap": change_gap},
            "same_inputs": prog["sampled"] == ref["sampled"],
            "detail": {"sampled": prog["sampled"],
                       "reference_sampled": ref["sampled"],
                       "losses": prog["losses"],
                       "reference_losses": ref["losses"],
                       "grad_leaf": grad_leaf, "change_leaf": change_leaf,
                       "leaves_compared": len(keep),
                       "active": [int(prog["final"][("anchors", "active")]
                                      .sum()),
                                  int(ref["final"][("anchors", "active")]
                                      .sum())]}}
