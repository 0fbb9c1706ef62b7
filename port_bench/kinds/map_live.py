"""Traffic kind "map_live": the mapper while the tracker runs. Keyframes
arrive at `rate` a second, each with `points` new map points, pushed by a
producer thread through the protocol's MappingOperation queue; Mapper.run
starts from iteration 0, waits for min_num_initial_map_kfs keyframes,
initialises the map from their points and trains while more arrive, each
arrival handled by the mapper loop (mapper.apply_op: the keyframe added,
its points inserted).

Set-up replays the first operations synchronously on a mapper of its own:
the first min_num_initial_map_kfs, then one more before each compared step
after the first (`compared_steps` in all), and holds those steps to the
plain reference (`reference_live.py`). The window then runs a fresh mapper
against the producer thread until its seconds are used (or trace_units
iterations).

Traffic keys: keyframe_every, rate (keyframes a second), points (a
keyframe's new points), compared_steps, trace_units, capture_every.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from port_bench import bench, reference_live, scene, trace

_map = bench.load_kind("map")


class Inputs:
    """The inputs from the seed: the keyframes (every keyframe_every-th
    frame pose of the room's trajectory, their RGB and depth), each
    keyframe's new points (where seeded pixels of it first hit the room)
    and the decoders the map starts from."""

    def __init__(self, cfg, traffic, seed, dev):
        self.cfg, self.traffic, self.seed, self.dev = cfg, traffic, seed, dev
        cam = cfg["camera"]
        self.w, self.h = cam["width"], cam["height"]
        poses = scene.trajectory(cfg["sequence"]["frames"])
        self.kf_poses = poses[::traffic["keyframe_every"]]
        self.rgb, self.depth = scene.keyframe_images(self.kf_poses, cam, seed,
                                                     dev)
        n = traffic["points"]
        self.points = [scene.surface_points([p], cam, n, seed * 1000 + i,
                                            dev).cpu().numpy()
                       for i, p in enumerate(self.kf_poses)]
        self.decoders = scene.seeded_decoders(cfg["model"], seed, dev)
        self.n_init = cfg["mapper"]["min_num_initial_map_kfs"]

    def operation(self, i: int):
        """Keyframe i's MappingOperation: the keyframe and its points."""
        from segs_slam_tpu_torch.slam.protocol import (
            KeyframeData,
            MappingOperation,
            OperationKind,
        )

        q, t = self.kf_poses[i]
        n = self.traffic["points"]
        return MappingOperation(
            kind=OperationKind.LOCAL_MAPPING_BA,
            keyframes=[KeyframeData(kf_id=i, camera_id=0, quat=q, trans=t,
                                    image=self.rgb[i], depth=self.depth[i])],
            points_xyz=self.points[i],
            point_ids=np.arange(i * n, (i + 1) * n))

    def reference(self, precision: str = "f32") -> dict:
        """The reference's compared steps from the same operations."""
        cfg = self.cfg
        stacked = scene.camera_inputs(self.kf_poses, cfg["camera"], self.dev)
        k0, steps = self.n_init, self.traffic["compared_steps"]
        cams = {i: scene.view(stacked, i) for i in range(k0 + steps - 1)}
        gts = {i: torch.as_tensor(self.rgb[i], device=self.dev)
               for i in cams}
        arrivals = [None] + [(i, self.points[i])
                             for i in range(k0, k0 + steps - 1)]
        init, sampled, losses, first, final = reference_live.live_steps(
            list(range(k0)), np.concatenate(self.points[:k0]), arrivals,
            self.decoders, cams, gts, cfg["model"], cfg["optimization"],
            bench.reference_raster(cfg), self.w, self.h, self.seed,
            cfg["mapper"]["new_keyframe_times_of_use"],
            scene.nerfpp_radius(self.kf_poses[:k0]), precision)
        return {"initial": init, "sampled": sampled, "losses": losses,
                "first": first, "final": final}


def traced(traffic: dict) -> dict:
    return traffic


def control(x: Inputs, precision: str) -> dict:
    """The compared numbers with the reference in `precision` (the control
    or the half-image fault) in the program's place."""
    ref = x.reference()
    return _map.compare_steps(x.reference(precision), ref, ref["initial"])


class _Live:
    """A fresh Trainer and Mapper, from iteration 0, whose map starts from
    the harness's decoders."""

    def __init__(self, x: Inputs):
        from segs_slam_tpu_torch.core.camera import Camera
        from segs_slam_tpu_torch.models.decoders import Decoders
        from segs_slam_tpu_torch.slam.mapper import Mapper
        from segs_slam_tpu_torch.slam.protocol import MappingQueue
        from segs_slam_tpu_torch.train.trainer import Trainer

        cfg, dev = x.cfg, x.dev
        cam = cfg["camera"]
        mc, oc, rc, mpc = bench.program_configs(cfg)
        self.mc = mc
        camera = Camera(0, x.w, x.h, cam["fx"], cam["fy"], cam["cx"],
                        cam["cy"])
        t = Trainer(mc, oc, rc, x.w, x.h, seed=x.seed,
                    keyframe_times_of_use=mpc.new_keyframe_times_of_use,
                    device=str(dev))
        t.scene.add_camera(camera)
        gen = torch.Generator(device=dev).manual_seed(0)
        dec = Decoders(mc, generator=gen, device=dev)
        with torch.no_grad():
            for name, p in dec.named_parameters():
                p.copy_(x.decoders[name])
        initialize = t.initialize_map

        def initialize_map(points, decoders=None):
            return initialize(points, decoders=dec)

        t.initialize_map = initialize_map
        self.trainer = t
        self.queue = MappingQueue()
        self.mapper = Mapper(self.queue, t, camera, mpc)


class Cell:
    """Mapper.run from iteration 0 against keyframes arriving at `rate`."""

    def __init__(self, inputs: Inputs, trace_on: bool):
        self.inputs, self.trace_on = inputs, trace_on
        self.traffic = inputs.traffic
        self.span = trace.spans(trace_on)

    def setup(self):
        """The replay: the initial keyframes, then an operation before each
        compared step after the first, applied by Mapper.run at fixed
        iterations; the program's compared outputs kept, its mapper
        dropped."""
        x, steps = self.inputs, self.traffic["compared_steps"]
        live = _Live(x)
        t = live.trainer
        iterate = t.train_iteration
        sample = t.scene.sample_sliding_window_keyframe
        sampled, metrics, first = [], [], {}

        def train_iteration():
            m = iterate()
            metrics.append(m)
            if not first:
                first.update(_map._adam_grads(t.state.adam))
            return m

        def sample_keyframe():
            kf = sample()
            sampled.append(kf.kf_id)
            return kf

        t.train_iteration = train_iteration
        t.scene.sample_sliding_window_keyframe = sample_keyframe
        for i in range(x.n_init):
            live.queue.push(x.operation(i))
        for n in range(steps):
            if n:
                live.queue.push(x.operation(x.n_init + n - 1))
            live.mapper.run(max_iterations=n + 1)
        self.program = {"sampled": sampled,
                        "losses": [float(m["loss"]) for m in metrics],
                        "first": first, "final": _map._params(t.state)}
        del live, t
        bench.sync(x.dev)
        self.live = _Live(x)
        self._wrap()

    def _wrap(self):
        """Instance wrappers on the window's mapper: the host span of each
        train_iteration, and the abort at the deadline or at max_units."""
        t, cellf = self.live.trainer, self
        iterate = t.train_iteration
        self.spans = []
        self.count = 0
        self.deadline = None
        self.max_units = None

        def train_iteration():
            t0 = time.perf_counter()
            with cellf.span("bench.iteration"):
                m = iterate()
            t1 = time.perf_counter()
            cellf.spans.append(t1 - t0)
            cellf.count += 1
            cellf.last_metrics = m
            if (t1 >= cellf.deadline or (cellf.max_units is not None
                                         and cellf.count >= cellf.max_units)):
                cellf.live.mapper.abort()
            return m

        t.train_iteration = train_iteration

    def compared_run(self):
        """The runs the compared outputs need beyond set-up: none."""

    def window(self, seconds: float, max_units: int | None = None):
        """Mapper.run against the producer thread until `seconds` have
        passed (or max_units iterations); returns (units, window
        seconds)."""
        x, live = self.inputs, self.live
        stop = threading.Event()
        period = 1.0 / self.traffic["rate"]

        def produce(t0):
            for i in range(len(x.kf_poses)):
                if stop.wait(max(0.0, t0 + i * period - time.perf_counter())):
                    return
                live.queue.push(x.operation(i))
            live.mapper.signal_stop()

        t0 = time.perf_counter()
        self.deadline = t0 + seconds
        self.max_units = max_units
        producer = threading.Thread(target=produce, args=(t0,), daemon=True)
        producer.start()
        try:
            live.mapper.run()
        finally:
            stop.set()
            producer.join()
        bench.sync(x.dev)
        return self.count, time.perf_counter() - t0

    def readings(self) -> dict:
        return {"spans": list(self.spans)}

    def path(self) -> dict:
        t = self.live.trainer
        m = self.last_metrics
        return {"keyframes": len(t.scene.keyframes),
                "n_active": int(m["n_active"]),
                "capacity": self.live.mc.capacity,
                "num_compact": int(m["num_compact"]),
                "compact": t.raster_config.compact,
                "iteration": t.iteration}

    def release(self):
        """The program's compared outputs kept (set-up's); the window's
        mapper freed."""
        del self.live

    def check(self) -> dict:
        ref = self.inputs.reference()
        return _map.compare_steps(self.program, ref, ref["initial"])
