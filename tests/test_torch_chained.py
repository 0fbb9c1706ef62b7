"""The port's ChainedEvalRenderer (decode -> project -> blend) and
project_to_image against the JAX package on the CPU:
tests/test_chained_renderer.py's two cases (the unpacked chain equals the
differentiable render, atol 1e-5, and JAX's chain, atol 2e-4), the packed
chain against JAX's packed chain (atol 2e-4) and against the unpacked image
within the packed bounds of tests/test_packed_binning.py (max 2e-2, mean
2e-3), and the debug projection's points, radii, colours and validity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segs_slam_tpu.models.renderer import ChainedEvalRenderer as JChained
from segs_slam_tpu.models.renderer import project_to_image as j_project
from segs_slam_tpu_torch.models.renderer import (
    ChainedEvalRenderer,
    EvalRenderer,
    project_to_image,
    render,
)
from test_torch_eval_render import W, H, _configs, _scene
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

CASES = [("flat", dict(compact=256, kmax=8)),
         ("dual_rate", dict(compact=256, kmax=8, ksmall=2, nlarge=64))]


@pytest.mark.parametrize("case,kw", CASES)
def test_chained_matches_fused_and_jax(case, kw):
    seed = 3 if case == "flat" else 5
    jmc, ja, jd, jcam, mc, anchors, dec, cam = _scene(seed=seed)
    rj, rt = _configs(**kw)
    bg = torch.zeros(3)
    chain = ChainedEvalRenderer(mc, rt, W, H, bg, packed=False,
                                device="cpu")
    chained = chain(anchors, dec, cam)
    with torch.no_grad():
        fused = render(anchors, dec, cam, W, H, bg, mc, rt).image
    jchained = JChained(jmc, rj, W, H, jnp.zeros(3), interpret=True,
                        packed=False)(ja, jd, jcam)
    assert chained.shape == fused.shape == (3, H, W)
    assert float(fused.max()) > 0.0
    np.testing.assert_allclose(chained.numpy(), fused.numpy(), atol=1e-5)
    np.testing.assert_allclose(chained.numpy(), np.asarray(jchained),
                               atol=2e-4)


@pytest.mark.parametrize("case,kw", CASES)
def test_packed_chain_matches_jax(case, kw):
    """The packed chain (K3's plain version) against JAX's packed chain and
    against the unpacked image; its stages compose to EvalRenderer's
    image."""
    jmc, ja, jd, jcam, mc, anchors, dec, cam = _scene(seed=5)
    rj, rt = _configs(**kw)
    bg = torch.zeros(3)
    chain = ChainedEvalRenderer(mc, rt, W, H, bg, device="cpu")
    assert chain.packed
    neural = chain.decode(anchors, dec, cam)
    feats, aux = chain.project(neural, cam)
    packed = chain.blend(feats, aux).numpy()
    ref = ChainedEvalRenderer(mc, rt, W, H, bg, packed=False,
                              device="cpu")(anchors, dec, cam).numpy()
    jpacked = np.asarray(JChained(jmc, rj, W, H, jnp.zeros(3),
                                  interpret=True)(ja, jd, jcam))
    np.testing.assert_allclose(packed, jpacked, atol=2e-4)
    assert ref.max() > 0.0
    np.testing.assert_allclose(packed, ref, atol=2e-2)
    assert np.abs(packed - ref).mean() < 2e-3
    torch.testing.assert_close(
        EvalRenderer(mc, rt, W, H, bg, device="cpu")(anchors, dec, cam),
        torch.from_numpy(packed), rtol=0, atol=0)


def test_project_to_image_matches_jax():
    jmc, ja, jd, jcam, mc, anchors, dec, cam = _scene(seed=3)
    rj, rt = _configs(compact=256, kmax=8)
    ref = jax.jit(j_project, static_argnums=(3, 4, 5, 6))(ja, jd, jcam, W, H,
                                                        jmc, rj)
    ours = project_to_image(anchors, dec, cam, W, H, mc, rt)
    assert ours.keys() == ref.keys()
    valid = ours["valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(ref["valid"]))
    assert valid.sum() > 10
    np.testing.assert_array_equal(ours["radii"].numpy(),
                                  np.asarray(ref["radii"]))
    for key in ("points2d", "color"):
        np.testing.assert_allclose(ours[key].numpy()[valid],
                                   np.asarray(ref[key])[valid], atol=2e-4,
                                   err_msg=key)


@pytest.mark.cuda
def test_chained_on_card_matches_cpu():
    """Both chains on the card (K3 packed, K1 unpacked) against the CPU
    path's plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 and K3 are CUDA C++ with no "
                    "CPU mode)")
    import dataclasses

    *_, mc, anchors, dec, cam = _scene(seed=5)
    rt = _configs(compact=256, kmax=8, ksmall=2, nlarge=64)[1]
    for packed in (True, False):
        imgs = []
        for dev in ("cpu", "cuda"):
            a = dataclasses.replace(anchors, **{
                f.name: getattr(anchors, f.name).to(dev)
                for f in dataclasses.fields(anchors)})
            imgs.append(ChainedEvalRenderer(
                mc, rt, W, H, torch.zeros(3), packed=packed, device=dev)(
                    a, dec.to(dev),
                    {k: v.to(dev) for k, v in cam.items()}).cpu())
        np.testing.assert_allclose(imgs[1].numpy(), imgs[0].numpy(),
                                   atol=2e-4)
