"""The benchmark's tests: the checkout's root on sys.path, tiny CPU
versions of the cells, and the card fixture of the `cuda` tests."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_cell(workload: str, packed: bool | None = None):
    """(config, traffic, limits) of `workload` cut to a size the CPU runs
    in seconds: 64 x 48 images, 3 keyframes, a map of 256 anchors in 512
    slots, compact 1024. At 4 tile columns every cell takes the packed
    paths unless `packed` is False (the training binning, then, is f32)."""
    from port_bench import bench

    _entry, cfg, traffic = bench.cell(workload)
    cfg = copy.deepcopy(cfg)
    cfg["camera"] = {"width": 64, "height": 48, "fx": 40.0, "fy": 40.0,
                     "cx": 31.5, "cy": 23.5}
    cfg["sequence"] = {"frames": 30, "fps": 30}
    cfg["model"]["capacity"] = 512
    cfg["map"]["n_active"] = 256
    cfg["raster"].update(compact=1024, nlarge=128)
    if packed is not None:
        cfg["raster"]["packed_train"] = packed
    traffic = dict(traffic, warmup_iterations=2, trace_units=3,
                   warmup_views=1, sample_views=3, sample_within=4)
    return cfg, traffic, bench.load_json("limits", workload)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())
