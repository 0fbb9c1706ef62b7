"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at a
tiny size, once for each fault a cell can have (a step that returns its
state unchanged; half of the image left out of the loss, the mean taken
over the rest; an answer altered where it is produced). No cell spans
chips, so no exchange between chips can be left out."""

import pytest
import torch

from conftest import tiny_cell


def run(workload, packed=None):
    from port_bench import bench

    cfg, traffic, limits = tiny_cell(workload, packed)
    return bench.run_cell(workload, 2**31 + 23, 0.3, False,
                          torch.device("cpu"), cfg=cfg, traffic=traffic,
                          limits=limits, log=lambda *a, **k: None)


@pytest.mark.parametrize("workload,packed", [("replica_rgbd.map", False),
                                             ("tum_rgbd.map", True)])
def test_state_unchanged(monkeypatch, workload, packed):
    from segs_slam_tpu_torch.train import optimizer

    monkeypatch.setattr(optimizer, "update", lambda *a, **k: a[2])
    res = run(workload, packed)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] > \
        res["checks"]["change_gap"]["limit"]


@pytest.mark.parametrize("workload,packed", [("replica_rgbd.map", False),
                                             ("tum_rgbd.map", True)])
def test_half_the_image_left_out(monkeypatch, workload, packed):
    from segs_slam_tpu_torch.train import step

    loss = step.step_loss

    def half(out, gt, gt_depth, it, oc):
        h = gt.shape[1] // 2
        return loss(out._replace(image=out.image[:, :h]), gt[:, :h],
                    gt_depth, it, oc)

    monkeypatch.setattr(step, "step_loss", half)
    res = run(workload, packed)
    assert not res["correct"]


@pytest.mark.parametrize("workload", ["tum_rgbd.render",
                                      "replica_rgbd.render"])
def test_answer_altered(monkeypatch, workload):
    from segs_slam_tpu_torch.models.renderer import EvalRenderer

    counts = EvalRenderer.render_with_counts

    def altered(self, *a, **k):
        out = counts(self, *a, **k)
        img = out["image"].clone()
        img[:, : img.shape[1] // 4] += 0.05
        return dict(out, image=img)

    monkeypatch.setattr(EvalRenderer, "render_with_counts", altered)
    res = run(workload)
    assert not res["correct"]
