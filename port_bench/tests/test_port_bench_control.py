"""On the card, at the cell's own size: the control (the reference in the
next precision below the configuration's) fails the committed limits of
each cell, on one seed; the full readings of three seeds and more are in
PERF.md."""

import pytest

from conftest import manifest


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      manifest()["workloads"]])
def test_control_fails_the_limits(card, workload):
    from port_bench import bench, control

    limits = bench.load_json("limits", workload)
    out = control.readings(workload, 2**31 + 101, "control",
                           limits["control"], card)
    assert any(v > limits["limits"][k]["limit"]
               for k, v in out["numbers"].items()), out["numbers"]
