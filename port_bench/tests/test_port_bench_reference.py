"""The frozen reference against the port's CPU path at a tiny size: a
whole cell run on the CPU (set-up, window, the comparison) comes out
correct under the committed limits, on both training binnings and both
eval paths."""

import pytest
import torch

from conftest import tiny_cell


@pytest.mark.parametrize("workload,packed", [
    ("replica_rgbd.map", False), ("tum_rgbd.map", True),
    ("tum_rgbd.render", None)])
def test_cell_correct_on_cpu(workload, packed):
    from port_bench import bench

    cfg, traffic, limits = tiny_cell(workload, packed)
    res = bench.run_cell(workload, 2**31 + 11, 0.3, False,
                         torch.device("cpu"), cfg=cfg, traffic=traffic,
                         limits=limits, log=lambda *a, **k: None)
    assert res["correct"], res["checks"]
    assert list(res)[-2:] == ["checks", "_detail"]
    assert res["attempted"] >= 1


def test_map_reference_follows_the_program_closely():
    """At the f32 binning the reference's losses equal the program's to
    rounding, and both sides densify alike."""
    from port_bench import bench

    cfg, traffic, limits = tiny_cell("replica_rgbd.map", False)
    kind = bench.load_kind("map")
    x = kind.Inputs(cfg, traffic, 5, torch.device("cpu"))
    c = kind.Cell(x, False)
    c.setup()
    c.release()
    out = c.check()
    assert out["same_inputs"]
    d = out["detail"]
    assert len(d["losses"]) == len(d["reference_losses"]) == \
        traffic["compared_steps"]
    assert max(abs(a - b) / abs(b) for a, b in
               zip(d["losses"], d["reference_losses"])) < 1e-6
    assert out["numbers"]["first_loss_gap"] < 1e-6
    assert out["numbers"]["grad_gap"] < 1e-4
    a, b = out["detail"]["active"]
    assert a == b > cfg["map"]["n_active"]


def test_render_reference_same_inputs_same_image():
    """Two reference renders of one pose agree exactly, and the f32
    training binning's render equals the eval selection's where no
    capacity binds."""
    from port_bench import bench, reference

    cfg, traffic, _ = tiny_cell("tum_rgbd.render")
    x = bench.load_kind("render").Inputs(cfg, traffic, 3, torch.device("cpu"))
    a = x.reference([0, 1])
    b = x.reference([0, 1])
    assert all(torch.equal(a[i], b[i]) for i in a)
    rc = bench.reference_raster(cfg)
    rc["kmax"] = 31
    img_t = reference.eval_image(x.anchors, x.decoders, x.cam(0),
                                 cfg["model"], dict(rc, compact=1 << 20,
                                                    nlarge=1 << 20), 64, 48,
                                 False)
    rce, _ = reference.eval_config(dict(rc, compact=1 << 20), 64, 48)
    img_e = reference.eval_image(x.anchors, x.decoders, x.cam(0),
                                 cfg["model"], dict(rce, nmid=1 << 20,
                                                    nlarge=1 << 20), 64, 48,
                                 True)
    assert torch.allclose(img_t, img_e, atol=1e-6)
