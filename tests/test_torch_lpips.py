"""The port's LPIPS (eval/lpips.py, metrics.lpips_fn and the harness's
column) against the JAX package on the CPU, with tests/test_lpips.py's
random AlexNet-shaped weights made from a seed (no pretrained weights ship
with the repository): the distance at odd image sizes and with both
`normalize` values within rel 2e-4 / abs 1e-6 of make_lpips, 0 for an
image against itself, None without weights, and the harness's `lpips`
column equal to JAX's harness's on the same PNGs.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from segs_slam_tpu.eval import harness as jharness
from segs_slam_tpu.eval.lpips_jax import make_lpips as j_make_lpips
from segs_slam_tpu_torch.eval import harness, metrics
from segs_slam_tpu_torch.eval.lpips import make_lpips
from segs_slam_tpu_torch.io.convert import lpips_params_to_torch
from test_lpips import _random_params
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)


def _pair(seed, shape=(3, 63, 65)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.fixture(scope="module")
def params():
    return _random_params(np.random.default_rng(7))


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("shape", [(3, 63, 65), (3, 48, 64)],
                         ids=["odd", "even"])
def test_lpips_matches_jax(params, normalize, shape):
    a, b = _pair(8, shape)
    ours = make_lpips(lpips_params_to_torch(params), normalize=normalize)(
        torch.from_numpy(a), torch.from_numpy(b))
    ref = float(j_make_lpips(params, normalize=normalize)(
        jnp.asarray(a), jnp.asarray(b)))
    assert ours.dtype == torch.float32 and ours.shape == ()
    assert float(ours) == pytest.approx(ref, rel=2e-4, abs=1e-6)
    assert ref > 0.0


def test_identity_is_zero_and_monotone(params):
    fn = make_lpips(lpips_params_to_torch(params))
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (3, 64, 64)).astype(np.float32)
    noise = rng.normal(0, 1, img.shape).astype(np.float32)
    t = torch.from_numpy
    assert float(fn(t(img), t(img))) == pytest.approx(0.0, abs=1e-6)
    small = float(fn(t(img), t(np.clip(img + 0.02 * noise, 0, 1))))
    large = float(fn(t(img), t(np.clip(img + 0.2 * noise, 0, 1))))
    assert 0.0 < small < large


def test_missing_weights_gives_none(monkeypatch):
    monkeypatch.delenv("SEGS_LPIPS_WEIGHTS", raising=False)
    assert metrics.lpips_fn("cpu") is None
    monkeypatch.setenv("SEGS_LPIPS_WEIGHTS", "/nonexistent/file.pkl")
    assert metrics.lpips_fn("cpu") is None


def test_harness_lpips_column_matches_jax(params, tmp_path, monkeypatch,
                                          capsys):
    """evaluate_run over a run directory's rendered/ and ground_truth/
    PNGs: the `lpips` column with SEGS_LPIPS_WEIGHTS set (the mean over the
    pairs, within rel 2e-4 of JAX's harness), `lpips_skipped` without."""
    run = tmp_path / "run"
    for sub in ("rendered", "ground_truth"):
        (run / sub).mkdir(parents=True)
    for i in range(3):
        a, b = _pair(20 + i, (3, 40, 56))
        for sub, x in (("rendered", a), ("ground_truth", b)):
            Image.fromarray((x.transpose(1, 2, 0) * 255).astype(np.uint8)) \
                .save(run / sub / f"{i:06d}.png")
    (run / "psnr.txt").write_text("20.0\n")
    wpath = tmp_path / "w.pkl"
    with open(wpath, "wb") as f:
        pickle.dump(params, f)

    monkeypatch.delenv("SEGS_LPIPS_WEIGHTS", raising=False)
    out = harness.evaluate_run(run, device="cpu")
    assert out["lpips_skipped"] == 1.0 and "lpips" not in out
    monkeypatch.setenv("SEGS_LPIPS_WEIGHTS", str(wpath))
    out = harness.evaluate_run(run, device="cpu")
    ref = jharness.evaluate_run(run)
    assert "lpips_skipped" not in out and out.keys() == ref.keys()
    assert out["lpips"] == pytest.approx(ref["lpips"], rel=2e-4, abs=1e-6)
    assert out["lpips"] > 0.0
    capsys.readouterr()


@pytest.mark.cuda
def test_lpips_on_card_matches_cpu(params):
    """The convolutions in full f32 on the card (no TF32) agree with the
    CPU at rel 2e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    a, b = _pair(8)
    got = [float(make_lpips(lpips_params_to_torch(params, dev))(
        torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)))
        for dev in ("cpu", "cuda")]
    assert got[1] == pytest.approx(got[0], rel=2e-4, abs=1e-6)
