"""Traffic kind "train": the offline trainer, `train_colmap`'s path. Every
image is a keyframe (train_colmap adds them all), there is no mapper loop
and no queue to wait on: `Trainer.train` samples the keyframes, steps and
densifies. The map is resumed at an iteration of the densification window.
The first `compared_steps` iterations run in set-up and are held to the
reference (`reference_unbounded.py`, which hands a bounded configuration to
`reference.py`); the window drives `Trainer.train` in chunks until its
seconds are used.

Traffic keys: scene ("orbit", port_bench/scene_orbit.py, or "room",
port_bench/scene.py), keyframe_every, start_iteration, compared_steps,
warmup_iterations, chunk (iterations a `Trainer.train` call), trace_units
(a whole densification interval, so that the traced window holds one
adjust), capture_every (the traced iterations whose binned views the work
counts read), resumed_stats.
"""

from __future__ import annotations

import time

import torch

from port_bench import bench, reference_unbounded, scene, scene_orbit, trace

_map = bench.load_kind("map")


class _Lazy:
    """A keyframe's ground truth on the device when the reference asks for
    it, so that the reference holds only the images it samples."""

    def __init__(self, rgb, dev):
        self.rgb, self.dev = rgb, dev

    def __getitem__(self, i):
        return torch.as_tensor(self.rgb[i], device=self.dev)


def _check_program(cfg):
    """A configuration of compact = kmax = 0 asks for the exact binning; a
    program without it (no RasterConfig.exact) would clamp every footprint
    to nothing, so the run stops here, before any input is made."""
    from segs_slam_tpu_torch.ops.rasterizer import RasterConfig

    rc = cfg["raster"]
    if rc["kmax"] == 0 and not hasattr(RasterConfig, "exact"):
        raise SystemExit("port_bench: the program has no exact binning "
                         "(RasterConfig.exact), which this configuration's "
                         "compact = kmax = 0 asks for")


class Inputs:
    """The inputs from the seed: the keyframes (every keyframe_every-th
    frame pose of the scene's trajectory and its image; the room's depth
    too), the map seeded on the surfaces they see, the decoders and resumed
    densification statistics."""

    def __init__(self, cfg, traffic, seed, dev):
        _check_program(cfg)
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, dev
        cam = cfg["camera"]
        self.w, self.h = cam["width"], cam["height"]
        frames = cfg["sequence"]["frames"]
        if traffic["scene"] == "orbit":
            poses = scene_orbit.trajectory(frames, seed)
            self.kf_poses = poses[::traffic["keyframe_every"]]
            self.rgb = scene_orbit.keyframe_images(self.kf_poses, cam, seed,
                                                   dev)
            self.depth = [None] * len(self.kf_poses)
            self.anchors, self.decoders = scene_orbit.seeded_scene(
                cfg, self.kf_poses, seed, dev)
        else:
            poses = scene.trajectory(frames)
            self.kf_poses = poses[::traffic["keyframe_every"]]
            self.rgb, self.depth = scene.keyframe_images(self.kf_poses, cam,
                                                         seed, dev)
            self.anchors, self.decoders = scene.seeded_scene(
                cfg, self.kf_poses, seed, dev)
        self.radius = scene.nerfpp_radius(self.kf_poses)
        self.stats = scene.seeded_stats(cfg["model"], self.anchors["active"],
                                        traffic["resumed_stats"], seed, dev)

    def initial(self) -> dict:
        return _map.Inputs.initial(self)

    def reference(self, precision: str = "f32") -> dict:
        """The reference's compared steps from the same inputs."""
        cfg, tr = self.cfg, self.traffic
        stacked = scene.camera_inputs(self.kf_poses, cfg["camera"], self.dev)
        n = len(self.kf_poses)
        cams = [scene.view(stacked, i) for i in range(n)]
        oc = dict(cfg["optimization"], spatial_lr_scale=self.radius)
        sampled, losses, first, final = reference_unbounded.train_steps(
            self.anchors, self.decoders, self.stats, cams,
            _Lazy(self.rgb, self.dev), list(range(n)), tr["start_iteration"],
            tr["compared_steps"], cfg["model"], oc,
            bench.reference_raster(cfg), self.w, self.h, self.seed,
            cfg["mapper"]["new_keyframe_times_of_use"], precision)
        return {"sampled": sampled, "losses": losses, "first": first,
                "final": final}


def traced(traffic: dict) -> dict:
    return traffic


def control(x: Inputs, precision: str) -> dict:
    """The compared numbers with the reference in `precision` (the control
    or a planted fault) in the program's place."""
    return _map.compare_steps(x.reference(precision), x.reference(),
                              x.initial())


class Cell:
    """Trainer.train over the inputs, resumed at start_iteration."""

    def __init__(self, inputs: Inputs, trace_on: bool):
        from segs_slam_tpu_torch.core.camera import Camera
        from segs_slam_tpu_torch.core.keyframe import Keyframe
        from segs_slam_tpu_torch.ops.rasterizer import blend
        from segs_slam_tpu_torch.train.step import (
            DensifyStats,
            init_train_state,
        )
        from segs_slam_tpu_torch.train.trainer import Trainer

        self.inputs, self.trace_on = inputs, trace_on
        x, cfg, dev = inputs, inputs.cfg, inputs.dev
        self.traffic = x.traffic
        self.blend = blend
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
        self.first_grads = None
        self.watch = True
        self.count = 0

        def train_iteration():
            t0 = time.perf_counter()
            with span("bench.iteration"):
                m = iterate()
            cellf.spans.append(time.perf_counter() - t0)
            cellf.count += 1
            cellf.last_metrics = m
            if cellf.watch:
                cellf.step_metrics.append(m)
                if cellf.first_grads is None:
                    cellf.first_grads = _map._adam_grads(t.state.adam)
            return m

        def sample_keyframe():
            kf = sample()
            if cellf.watch and kf is not None:
                cellf.sampled.append(kf.kf_id)
            return kf

        t.train_iteration = train_iteration
        t.scene.sample_sliding_window_keyframe = sample_keyframe

    def setup(self):
        self.trainer.train(self.traffic["compared_steps"])
        self.final = _map._params(self.trainer.state)
        self.watch = False
        self.trainer.train(self.traffic["warmup_iterations"])
        bench.sync(self.inputs.dev)

    def compared_run(self):
        """The runs the compared outputs need beyond set-up: none."""

    def window(self, seconds: float, max_units: int | None = None):
        """Trainer.train in chunks until `seconds` have passed (or
        max_units iterations); returns (units, window seconds)."""
        self.spans.clear()
        self.count = 0
        chunk = self.traffic["chunk"]
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds and (
                max_units is None or self.count < max_units):
            n = chunk if max_units is None else min(chunk,
                                                    max_units - self.count)
            self.trainer.train(n)
        bench.sync(self.inputs.dev)
        return self.count, time.perf_counter() - t0

    def readings(self) -> dict:
        return {"spans": list(self.spans)}

    def path(self) -> dict:
        m = self.last_metrics
        rc = self.trainer.raster_config
        return {"exact_binnings": self.blend.train_binnings["exact"],
                "binned_gaussians": int(m["num_compact"]),
                "pairs": int(m["num_instances"]),
                "num_kmax_truncated": int(m["num_kmax_truncated"]),
                "compact": rc.compact, "kmax": rc.kmax,
                "n_active": int(m["n_active"]),
                "capacity": self.mc.capacity,
                "iteration": self.trainer.iteration}

    def release(self):
        """The program's compared outputs kept; the rest of its state
        freed."""
        self.program = {"sampled": self.sampled,
                        "losses": [float(m["loss"]) for m in
                                   self.step_metrics],
                        "first": self.first_grads, "final": self.final}
        del self.trainer, self.step_metrics, self.last_metrics

    def check(self) -> dict:
        return _map.compare_steps(self.program, self.inputs.reference(),
                                  self.inputs.initial())
