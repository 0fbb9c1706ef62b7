"""The cells of this benchmark's second model and of the live mapper, on the
CPU at a tiny size: `mip360_garden.train` (the exact binning, the "train"
kind, the orbit scene, `reference_unbounded.py`) and `tum_rgbd.map_live`
(the "map_live" kind, `reference_live.py`) come out correct, a planted
fault does not, and a program without the exact binning stops at once."""

import dataclasses
import importlib

import pytest
import torch

from conftest import tiny_cell

GARDEN, LIVE = "mip360_garden.train", "tum_rgbd.map_live"


def tiny(workload):
    """tiny_cell's cut, with the exact binning kept (compact = kmax = 0)
    and anchor scales of 0.5 m, so that at the tiny focal length (40 px)
    footprints still reach past 8 of the view's 12 tiles; the live cell
    with 20 keyframes of 40 points, arriving at 100 a second."""
    cfg, traffic, limits = tiny_cell(workload)
    if workload == GARDEN:
        cfg["raster"].update(compact=0, nlarge=0)
        cfg["map"]["anchor_scale"] = 0.5
    else:
        cfg["sequence"]["frames"] = 200
        traffic = dict(traffic, points=40, rate=100.0)
    return cfg, traffic, limits


def run(workload, trace_on=False):
    from port_bench import bench

    cfg, traffic, limits = tiny(workload)
    return bench.run_cell(workload, 2**31 + 7, 0.3, trace_on,
                          torch.device("cpu"), cfg=cfg, traffic=traffic,
                          limits=limits, log=lambda *a, **k: None)


@pytest.mark.parametrize("workload", [GARDEN, LIVE])
def test_cell_correct_on_cpu(workload):
    res = run(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1


def test_garden_traced_run_reads_the_route():
    """The traced run reads the exact binning's counters: pairs and
    gaussians a view, nothing dropped."""
    res = run(GARDEN, trace_on=True)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["pairs_per_view.train"]["value"] > \
        m["binned_gaussians.train"]["value"] > 0
    assert m["compact_dropped.train"]["value"] == 0
    assert "densify_ms.train" not in m  # the tiny window holds no adjust


@pytest.mark.parametrize("workload", [GARDEN, LIVE])
def test_half_the_image_left_out(monkeypatch, workload):
    from segs_slam_tpu_torch.train import step

    loss = step.step_loss

    def half(out, gt, gt_depth, it, oc):
        h = gt.shape[1] // 2
        return loss(out._replace(image=out.image[:, :h]), gt[:, :h],
                    gt_depth, it, oc)

    monkeypatch.setattr(step, "step_loss", half)
    assert not run(workload)["correct"]


def test_footprints_clamped_to_8_tiles(monkeypatch):
    """The program's projection clamping every footprint to 8 tiles around
    its centre, as the bounded binning does, while the binning stays
    exact: not correct."""
    trast = importlib.import_module(
        "segs_slam_tpu_torch.ops.rasterizer.rasterize")
    project = trast.preprocess_gaussians

    def clamped(*a, **k):
        a = list(a)
        a[8] = dataclasses.replace(a[8], compact=1, kmax=8)
        return project(*a, **k)

    monkeypatch.setattr(trast, "preprocess_gaussians", clamped)
    assert not run(GARDEN)["correct"]


def test_a_program_without_the_exact_binning_stops_at_once(monkeypatch):
    from segs_slam_tpu_torch.ops.rasterizer import preprocess

    monkeypatch.delattr(preprocess.RasterConfig, "exact")
    with pytest.raises(SystemExit, match="exact binning"):
        run(GARDEN)


def test_train_kind_runs_a_bounded_room_configuration():
    """The "train" kind on the room scene with a bounded configuration
    (tum_rgbd's packed training binning), held to reference.py through
    reference_unbounded's hand-off: a cell of the offline trainer on the
    rooms needs only a traffic file."""
    from port_bench import bench

    cfg, _, _ = tiny_cell("tum_rgbd.map")
    traffic = dict(bench.cell(GARDEN)[2], scene="room", keyframe_every=10,
                   warmup_iterations=2)
    kind = bench.load_kind("train")
    c = kind.Cell(kind.Inputs(cfg, traffic, 5, torch.device("cpu")), False)
    c.setup()
    c.release()
    out = c.check()
    limits = bench.load_json("limits", "tum_rgbd.map")["limits"]
    assert out["same_inputs"]
    for k, v in out["numbers"].items():
        assert v <= limits[k]["limit"], (k, v)
