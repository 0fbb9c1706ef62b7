"""The traced run on the CPU at a tiny size, the traced map window's place
in the densification interval, and the data-driven lookup of kinds and
end-to-end metrics."""

import pytest
import torch

from conftest import manifest, tiny_cell


def test_traced_map_run_reads_its_host_metrics():
    from port_bench import bench

    cfg, traffic, limits = tiny_cell("replica_rgbd.map", False)
    res = bench.run_cell("replica_rgbd.map", 2**31 + 31, 0.3, True,
                         torch.device("cpu"), cfg=cfg, traffic=traffic,
                         limits=limits, log=lambda *a, **k: None)
    assert res["correct"], res["checks"]
    assert res["attempted"] == traffic["trace_units"]
    assert res["metrics"]["step_host_ms.map"]["value"] > 0
    assert "mapper_loop_ms.map" in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # no card: no device operation, so no share of a roofline or a peak
    assert "blend_fwd_roofline.map" not in res["metrics"]


def test_traced_map_window_holds_a_densification():
    """The traced iterations follow the compared steps and the warm-up,
    and span a whole densification interval."""
    from port_bench import bench

    for w in manifest()["workloads"]:
        _entry, cfg, traffic = bench.cell(w["name"])
        if traffic["kind"] != "map":
            continue
        interval = cfg["optimization"]["update_interval"]
        first = (traffic["start_iteration"] + traffic["compared_steps"]
                 + traffic["warmup_iterations"] + 1)
        last = first + traffic["trace_units"] - 1
        assert any(i % interval == 0 for i in range(first, last + 1))
        assert cfg["optimization"]["update_from"] < first
        assert last < cfg["optimization"]["update_until"]


def test_capture_keeps_every_nth_call():
    from port_bench import bench

    cap = bench.Capture(every=3)
    try:
        cap.on = True
        kept = [cap.keep("fwd") for _ in range(7)]
        cap.on = False
        assert not cap.keep("fwd")
    finally:
        cap.close()
    assert kept == [True, False, False, True, False, False, True]


@pytest.mark.parametrize("name,ctx,value", [
    ("setup_s", {"setup_s": 4.5}, 4.5),
    ("map_iters_per_s", {"units": 30, "window_s": 2.0}, 15.0),
    ("render_fps", {"units": 0, "window_s": 2.0}, None),
    ("render_ms_p95", {"times": [0.01] * 19 + [0.03]}, None),
])
def test_end_to_end_readers(name, ctx, value):
    from port_bench import bench

    got = bench.load_end_to_end(name).read(ctx)
    if name == "render_ms_p95":
        assert 10.0 < got < 30.0
    else:
        assert got == value
