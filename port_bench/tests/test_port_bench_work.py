"""The work counts against hand counts on a tiny binned view."""

import torch

from port_bench import work


def _view(opacity: float, n: int):
    """One 16 x 16 tile, n instances of flat footprint (conic 0: G = 1 at
    every pixel) and the same opacity."""
    feats = torch.zeros((10, n))
    feats[0], feats[1] = 8.0, 8.0
    feats[5] = opacity
    feats[6:9] = 0.5
    start = torch.tensor([0], dtype=torch.int32)
    stop = torch.tensor([n], dtype=torch.int32)
    return feats, start, stop


def counts(opacity, n):
    feats, start, stop = _view(opacity, n)
    return work.pair_counts(feats, start, stop, 1, 16, 1 / 255, 0.99, 1e-4)


def test_two_half_opaque():
    # T: 1, 0.5, 0.25: every pixel tests and takes both
    c = counts(0.5, 2)
    assert c == {"fwd_tested": 512, "bwd_tested": 512, "taken": 512,
                 "walked_fwd": 2, "walked_bwd": 2}


def test_latch():
    # T before each: 1, .05, .0025, 1.25e-4, 6.25e-6: four tested, the
    # fourth would leave T under 1e-4, so three taken
    c = counts(0.95, 5)
    assert c == {"fwd_tested": 4 * 256, "bwd_tested": 3 * 256,
                 "taken": 3 * 256, "walked_fwd": 4, "walked_bwd": 3}


def test_work_and_bound():
    feats, start, stop = _view(0.95, 5)
    pairs = counts(0.95, 5)
    fwd, bwd = work.train_blend_work(start, 5, 256, pairs, 5)
    assert fwd == (5 * 40 + 8 + 12 + 256 * 24, 12 * 1024 + 16 * 768)
    assert bwd == (3 * 40 + 256 * 28 + 8 + 12 + 40 * 5, 12 * 768 + 50 * 768)
    ev = work.eval_blend_work(start, 256, pairs, 5)
    assert ev == (5 * 36 + 8 + 12 + 256 * 12, 12 * 1024 + 14 * 768)
    assert work.bound_s((3.35e12, 0.0)) == 1.0
    assert work.bound_s((0.0, 67e12)) == 1.0


def test_decode_columns_pack8():
    # p_xy = (1.0, 2.0) as f16, conic (a, b) = (0.5, 0), c2 = conic.c 0.25
    # | opacity 2047 << 16, c3 = rgb bytes (255, 0, 51)
    h = {1.0: 0x3C00, 2.0: 0x4000, 0.5: 0x3800, 0.25: 0x3400, 0.0: 0}
    cols = torch.tensor([[h[1.0] | h[2.0] << 16], [h[0.5]],
                         [h[0.25] | 2047 << 16], [255 | 51 << 16]],
                        dtype=torch.int64)
    cols = torch.where(cols >= 1 << 31, cols - (1 << 32), cols).to(
        torch.int32)
    rows = work.decode_columns(cols, pack8=True)[:, 0].tolist()
    assert rows[:6] == [1.0, 2.0, 0.5, 0.0, 0.25, 1.0]
    assert abs(rows[6] - 1.0) < 1e-7 and rows[7] == 0.0
    assert abs(rows[8] - 0.2) < 1e-7


def test_ops_counts():
    assert work.decoder_ops({"feat_dim": 32, "n_offsets": 10,
                             "appearance_dim": 32}, 1) == 15808 + 448
    assert work.loss_ops(64, 48, 1) > 0
