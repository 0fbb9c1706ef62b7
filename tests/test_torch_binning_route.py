"""The binning route, decided in one place: RasterConfig.train_binning and
RasterConfig.eval_binning on a table of configs and views that sits on
each side of every packed-layout limit (63 / 64 tile columns, 31 / 32 tile
rows, kmax 5 / 6, 31 / 32 and 0, compact 2^16 / 2^16 + 1, the tile id
above the depth key, 16 px tiles). On the CPU the training blend
(`train_binnings`) and EvalRenderer.packed take the route the methods
name."""

import pytest
import torch

from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.models.renderer import EvalRenderer
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from segs_slam_tpu_torch.ops.rasterizer import blend as tblend
from segs_slam_tpu_torch.ops.rasterizer.preprocess import (
    MAX_COMPACT_PACKED_TRAIN,
)
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

BASE = dict(tile=16, compact=1024, kmax=8, ksmall=4, nlarge=64,
            packed_train=True)

# (name, config fields over BASE, eval_variant of them, width, height,
# EvalRenderer's packed flag, training route, eval route)
CASES = [
    ("63 columns", {}, False, 1008, 480, True, "packed", "f16"),
    ("64 columns", {}, False, 1009, 480, True, "f32", "f32"),
    ("packed off", {}, False, 640, 480, False, "packed", "packed"),
    ("packed_train off", dict(packed_train=False), False, 640, 480, True,
     "f32", "f16"),
    ("31 rows", {}, True, 1008, 496, True, "f32", "sel_direct"),
    ("32 rows", {}, True, 1008, 497, True, "packed", "f16"),
    ("tile ids over the depth key", {}, False, 1008, 528, True, "f32",
     "f32"),
    ("kmax 5", dict(kmax=5, ksmall=2), True, 640, 480, True, "packed",
     "f16"),
    ("kmax 6", dict(kmax=6, ksmall=2), True, 640, 480, True, "f32",
     "sel_direct"),
    ("kmax 31", dict(kmax=31), False, 640, 480, True, "packed", "f16"),
    ("kmax 31 eval", dict(kmax=31), True, 640, 480, True, "f32",
     "sel_direct"),
    ("kmax 32", dict(kmax=32), True, 640, 480, True, "f32", "f32"),
    ("kmax 0", dict(compact=0, kmax=0, ksmall=0, nlarge=0,
                    packed_train=False), True, 640, 480, True, "exact",
     "exact"),
    ("compact 2^16", dict(compact=MAX_COMPACT_PACKED_TRAIN), False, 640,
     480, True, "packed", "f16"),
    ("compact 2^16 + 1", dict(compact=MAX_COMPACT_PACKED_TRAIN + 1), False,
     640, 480, True, "f32", "f16"),
    ("8 px tiles", dict(tile=8), True, 320, 240, True, "f32", "f32"),
]


def _config(fields: dict, variant: bool, w: int, h: int) -> RasterConfig:
    rc = RasterConfig(**dict(BASE, **fields))
    return rc.eval_variant(w, h) if variant else rc


def _inputs(rc: RasterConfig, tx: int, ty: int, n: int = 6):
    """n gaussians of 2 x 2 tiles spread over the grid: the blend's
    (feats, aux)."""
    k = torch.arange(n)
    mx = (k * (tx - 2) // max(n - 1, 1)).to(torch.int32)
    my = (k * (ty - 2) // max(n - 1, 1)).to(torch.int32)
    t = float(rc.tile)
    feats = torch.stack([
        (mx.float() + 1.0) * t, (my.float() + 1.0) * t,
        torch.full((n,), 0.05), torch.zeros(n), torch.full((n,), 0.05),
        torch.full((n,), 0.6), *torch.rand(3, n,
                                           generator=torch.Generator()
                                           .manual_seed(0))])
    aux = {"rect_min_x": mx, "rect_min_y": my,
           "rect_w": torch.full((n,), 2, dtype=torch.int32),
           "touched": torch.full((n,), 4, dtype=torch.int32),
           "depth": 1.0 + k.float(), "alive": torch.ones(n, dtype=torch.bool)}
    return feats, aux


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_route_of_each_limit(case):
    _, fields, variant, w, h, packed, train, evaluated = case
    rc = _config(fields, variant, w, h)
    tx, ty = rc.grid(w, h)
    assert rc.train_binning(tx, ty) == train
    assert rc.eval_binning(tx, ty, packed) == evaluated

    renderer = EvalRenderer(ModelConfig(), rc, w, h, torch.zeros(3),
                            packed=packed, device="cpu")
    assert renderer.packed == (evaluated in ("sel_direct", "f16"))

    feats, aux = _inputs(rc, tx, ty)
    if rc.sel_direct:  # an eval config: the training blend refuses it
        with pytest.raises(ValueError):
            tblend.binned_blend(feats, aux, torch.zeros(3), rc, tx, ty)
        return
    before = dict(tblend.train_binnings)
    color, *_ = tblend.binned_blend(feats, aux, torch.zeros(3), rc, tx, ty)
    assert color.shape == (tx * ty, 3, rc.tile * rc.tile)
    after = dict(tblend.train_binnings)
    assert after == dict(before, **{train: before[train] + 1})


def test_eval_variant_agrees_with_the_route():
    """eval_variant upgrades a config exactly where the upgraded config's
    view takes the direct-selection binning, and returns the config itself
    elsewhere."""
    for _, fields, _, w, h, _, _, _ in CASES:
        rc = RasterConfig(**dict(BASE, **fields))
        ev = rc.eval_variant(w, h)
        takes = ev.eval_binning(*ev.grid(w, h)) == "sel_direct"
        assert takes == (ev is not rc), (fields, w, h)
