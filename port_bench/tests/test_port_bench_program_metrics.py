"""The per-layer metrics read from the program's own spans and counters
(port_bench/program.py over segs_slam_tpu_torch.utils.tracing): the tiny
CPU traced map and render runs report each, and every reader gives None
where the registry holds nothing or the program has none."""

import sys

import pytest
import torch

from conftest import manifest, tiny_cell

MAP = ("mapper_wait_ms.map", "step_inputs_ms.map", "densify_ms.map",
       "binning_host_ms.map", "compact_dropped.map")
RENDER = ("decode_host_ms.render", "binning_host_ms.render")


def _traced(workload, traffic_changes, packed=None):
    from port_bench import bench
    from segs_slam_tpu_torch.utils import tracing

    cfg, traffic, limits = tiny_cell(workload, packed)
    traffic = dict(traffic, **traffic_changes)
    tracing.reset()
    try:
        return bench.run_cell(workload, 2**31 + 77, 0.3, True,
                              torch.device("cpu"), cfg=cfg, traffic=traffic,
                              limits=limits, log=lambda *a, **k: None)
    finally:
        tracing.reset()


def test_traced_map_run_reports_the_program_metrics():
    # resumed so that the three traced iterations are 5200-5202: the
    # window holds the adjust at 5200
    res = _traced("replica_rgbd.map", {"start_iteration": 5194}, False)
    assert res["correct"], res["checks"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(MAP) <= set(got)
    # one queue.pop(timeout=0.01) an iteration on an empty queue
    assert 9.0 < got["mapper_wait_ms.map"] < 100.0
    assert got["densify_ms.map"] > 0
    assert got["step_inputs_ms.map"] > 0 and got["binning_host_ms.map"] > 0
    assert got["compact_dropped.map"] == 0  # 256 anchors, compact 1024
    # the program's spans lie inside the harness's iteration span
    assert got["step_inputs_ms.map"] + got["binning_host_ms.map"] \
        < got["step_host_ms.map"]


def test_traced_render_run_reports_the_program_metrics():
    res = _traced("tum_rgbd.render", {})
    assert res["correct"], res["checks"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(RENDER) <= set(got)
    assert got["decode_host_ms.render"] > 0
    assert got["binning_host_ms.render"] > 0


def test_each_program_metric_has_its_entry():
    entries = {e["name"]: e for e in manifest()["per_layer"]}
    for name in MAP + RENDER:
        e = entries[name]
        assert e["source"] in ("program_span", "program_counter")
        kind = name.rsplit(".", 1)[1]
        assert e["workloads"] == [w["name"] for w in manifest()["workloads"]
                                  if w["traffic"] == kind]


@pytest.mark.parametrize("absent", [False, True],
                         ids=["empty_registry", "no_registry"])
@pytest.mark.parametrize("name", MAP + RENDER)
def test_program_metric_reads_none_without_records(name, absent,
                                                   monkeypatch):
    """An empty registry (nothing fired in the window) reads None; so does
    a program without the registry (its import fails, as in a program that
    predates it), even where the registry would hold every span."""
    import segs_slam_tpu_torch.utils
    from torch.profiler import ProfilerActivity, profile

    from port_bench import bench
    from segs_slam_tpu_torch.utils import tracing

    tracing.reset()
    ctx = {"units": 30, "window_s": 1.0, "spans": [0.05] * 30,
           "times": [0.02] * 30}
    if absent:
        with profile(activities=[ProfilerActivity.CPU]):
            for span in ("mapper.queue_wait", "train_step.inputs",
                         "train_step.densify", "render.binning",
                         "render.prefilter", "render.decode"):
                with tracing.span(span):
                    pass
            tracing.count("render.compact_dropped", 3)
        assert bench.load_metric(name).read(ctx) is not None
        monkeypatch.delattr(segs_slam_tpu_torch.utils, "tracing")
        monkeypatch.setitem(sys.modules, "segs_slam_tpu_torch.utils.tracing",
                            None)
    try:
        assert bench.load_metric(name).read(ctx) is None
    finally:
        monkeypatch.undo()
        tracing.reset()
