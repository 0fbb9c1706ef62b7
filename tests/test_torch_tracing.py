"""The port's spans and counters (segs_slam_tpu_torch/utils/tracing.py) on
the CPU at a tiny size: nothing recorded without a profiler session; inside
torch.profiler.profile, Mapper.run, the train step, densification and one
EvalRenderer view record their named spans and counters, each span once per
profiler event of the same name, nested inside its parent range; device
counts summed exactly; reset empties the registry; updates from many
threads are not lost.
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from segs_slam_tpu_torch.core import Camera, Keyframe
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from segs_slam_tpu_torch.slam.mapper import Mapper, MapperConfig
from segs_slam_tpu_torch.slam.producers import SyntheticOracleProducer
from segs_slam_tpu_torch.slam.protocol import MappingQueue
from segs_slam_tpu_torch.train.config import OptimizationConfig
from segs_slam_tpu_torch.train.trainer import Trainer
from segs_slam_tpu_torch.utils import tracing
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

W = H = 32
MODEL = dict(feat_dim=8, n_offsets=4, appearance_dim=8, embedding_dim=4,
             capacity=128, voxel_size=0.05)
# densification every 10 iterations from 5 to 200: two adjusts in the
# profiled iterations 96-112
OPT = dict(use_frequency_regularization=False, start_stat=2, update_from=5,
           update_interval=10, update_until=200)
RASTER = dict(tile=16, compact=256, kmax=16, chunk=64)

STEP_SPANS = {f"train_step.{s}" for s in (
    "inputs", "forward", "loss", "backward", "stats", "adam", "metrics",
    "densify")}
RENDER_SPANS = {f"render.{s}" for s in (
    "prefilter", "decode", "project", "binning", "blend", "blend_bwd")}
MAPPER_SPANS = {"mapper.queue_wait", "mapper.apply_op", "mapper.log"}


def _mapper():
    """A Trainer and Mapper over six keyframes, the producer's six
    operations waiting in the queue."""
    cam = Camera(camera_id=0, width=W, height=H, fx=28.0, fy=28.0,
                 cx=W / 2, cy=H / 2)
    rng = np.random.default_rng(0)
    kfs = [Keyframe(kf_id=i, camera=cam, quat=[1, 0, 0, 0],
                    trans=[0.05 * i, 0, 0],
                    image=rng.uniform(0.1, 0.9, (3, H, W)).astype(np.float32))
           for i in range(6)]
    trainer = Trainer(ModelConfig(**MODEL), OptimizationConfig(**OPT),
                      RasterConfig(**RASTER), width=W, height=H,
                      device="cpu")
    trainer.scene.add_camera(cam)
    queue = MappingQueue()
    pts = np.random.default_rng(1)
    SyntheticOracleProducer(
        kfs, cam, queue,
        sparse_points_fn=lambda kf: pts.uniform([-0.6, -0.5, 1.2],
                                                [0.6, 0.5, 3.0],
                                                (60, 3))).run()
    return trainer, Mapper(queue, trainer, cam,
                           MapperConfig(min_num_initial_map_kfs=3))


def _view(trainer):
    """One EvalRenderer view of the first keyframe."""
    kf = trainer.scene.keyframes[0]
    cam, _ = trainer._kf_inputs(kf)
    return trainer.eval_renderer()(trainer.state.anchors,
                                   trainer.state.decoders, cam)


def test_without_a_profiler_nothing_is_recorded():
    tracing.reset()
    trainer, mapper = _mapper()
    mapper.run(max_iterations=12)
    _view(trainer)
    assert trainer.iteration == 12
    assert tracing.read() == {"spans": {}, "counts": {}}
    # off, every span is the one shared no-op context
    assert tracing.span("a") is tracing.span("b")
    assert not tracing.enabled()


@pytest.fixture(scope="module")
def profiled():
    """Three operations initialise the map and one more trains outside the
    profiler; then, profiled, Mapper.run from iteration 96 to 112 (the last
    two operations, a log read at 100, adjusts at 100 and 110) and one
    EvalRenderer view, each inside its own parent range. Returns the
    registry, the profiler's events, whether each pop returned an
    operation, the queue's depth before the window and the iterations."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        trainer, mapper = _mapper()
        mapper.run(max_iterations=1)
        trainer.eval_renderer()  # calibrated outside the window
        trainer.iteration = 95
        pops = []
        pop = mapper.queue.pop

        def counted_pop(timeout=None):
            op = pop(timeout=timeout)
            pops.append(op is not None)
            return op

        mapper.queue.pop = counted_pop
        depth = mapper.queue.qsize()
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("test.mapper"):
                mapper.run(max_iterations=112)
            with record_function("test.view"):
                _view(trainer)
        reg = tracing.read()
        tracing.reset()
    finally:
        torch.set_num_threads(before)
    return {"reg": reg, "events": prof.events(), "pops": pops,
            "depth": depth, "iterations": trainer.iteration - 95}


def test_profiled_runs_record_their_spans_and_counters(profiled):
    reg, pops = profiled["reg"], profiled["pops"]
    spans, counts = reg["spans"], reg["counts"]
    assert STEP_SPANS | RENDER_SPANS | MAPPER_SPANS <= set(spans)
    assert profiled["iterations"] == 17
    # one pop a loop iteration: each pops once and trains once
    assert spans["mapper.queue_wait"]["calls"] == len(pops) == 17
    assert counts["mapper.ops"] == sum(pops) == 2
    # every pass trains, so only the first pop of the call waits
    assert counts["mapper.pops_unwaited"] == 16
    assert spans["mapper.apply_op"]["calls"] == 2
    assert counts["mapper.queue_depth_max"] == profiled["depth"] == 2
    assert spans["mapper.log"]["calls"] == 1
    assert spans["train_step.densify"]["calls"] \
        == counts["densify.adjusts"] == 2
    assert counts["densify.grown"] >= 0 and counts["densify.pruned"] >= 0
    for name in STEP_SPANS - {"train_step.densify"}:
        assert spans[name]["calls"] == 17, name
    # 17 training renders and the view
    for name in RENDER_SPANS - {"render.blend_bwd"}:
        assert spans[name]["calls"] == 18, name
    assert spans["render.blend_bwd"]["calls"] == 17
    assert counts["render.compact_dropped"] == 0  # 96 anchors, compact 256
    assert counts["render.kmax_truncated"] >= 0
    assert all(s["s"] > 0 for s in spans.values())


PARENTS = {"mapper.": ("test.mapper",), "train_step.": ("test.mapper",),
           "render.": ("train_step.forward", "test.view"),
           "render.blend_bwd": ("train_step.backward",)}


def _parents(name):
    key = name if name in PARENTS else name.split(".")[0] + "."
    return PARENTS[key]


def test_spans_are_profiler_ranges_nested_in_their_parents(profiled):
    events = profiled["events"]
    by_name = {}
    for e in events:
        by_name.setdefault(e.name, []).append(e.time_range)
    for name, s in profiled["reg"]["spans"].items():
        ranges = by_name.get(name, [])
        assert len(ranges) == s["calls"], name
        outer = [r for p in _parents(name) for r in by_name[p]]
        for r in ranges:
            assert any(o.start <= r.start and r.end <= o.end
                       for o in outer), name


def test_device_counts_fold_exactly_and_reset_empties():
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(3 * tracing._FOLD + 5):
            tracing.count("x", torch.tensor(i, dtype=torch.int32))
        tracing.count("x", 7)
        tracing.count("y", torch.tensor(0.5))
        for v in (3, 9, 4):
            tracing.peak("p", v)
        with tracing.span("s"):
            pass
        # device values wait by reference only up to a batch
        assert len(tracing._REGISTRY._pending["x"]) < tracing._FOLD
    n = 3 * tracing._FOLD + 5
    got = tracing.read()
    assert got["counts"] == {"x": n * (n - 1) // 2 + 7, "y": 0.5, "p": 9}
    assert got["spans"]["s"]["calls"] == 1
    tracing.count("x", 1)  # no session: ignored
    assert tracing.read()["counts"]["x"] == n * (n - 1) // 2 + 7
    tracing.reset()
    assert tracing.read() == {"spans": {}, "counts": {}}


def test_idle_loop_records_its_sleep():
    """A mapper with no keyframe to train sleeps after every empty wait."""
    trainer, mapper = _mapper()
    mapper.queue.drain()
    mapper.initialized = True
    tracing.reset()
    stop = threading.Timer(0.1, mapper.abort)
    with profile(activities=[ProfilerActivity.CPU]):
        stop.start()
        mapper.run()
    stop.join(timeout=10)
    assert not stop.is_alive()
    reg = tracing.read()
    spans = reg["spans"]
    tracing.reset()
    assert spans["mapper.idle"]["calls"] == spans["mapper.queue_wait"][
        "calls"] >= 1
    assert trainer.iteration == 0
    # no pass trained, so every pop waited
    assert reg["counts"].get("mapper.pops_unwaited", 0) == 0


def test_updates_from_many_threads_are_not_lost():
    tracing.reset()
    n_threads = 2 * (os.cpu_count() or 4)  # more threads than cores
    per = max(100, 8000 // n_threads)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                tracing.count("host", 1)
                tracing.count("dev", torch.ones((), dtype=torch.int32))
                with tracing.span("s"):
                    pass

        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = tracing.read()
    tracing.reset()
    assert got["counts"] == {"host": n_threads * per, "dev": n_threads * per}
    assert got["spans"]["s"]["calls"] == n_threads * per
