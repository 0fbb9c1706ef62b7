"""The port's SH colour mode (ops/sh.py and rasterize(shs=...)) against the
JAX package on the CPU: tests/test_sh.py's four cases on the port, eval_sh
against the JAX function at every degree, and rasterize's image (atol
2e-4, as tests/test_rasterizer.py) and gradients with respect to the SH
coefficients and the means (atol 2e-4 after scaling by their largest) from
the same seeded inputs. The coefficients keep sh_to_color's clamp at 0 out
of reach, where jnp.maximum's gradient and torch's differ. The kernels
themselves run only on a card: see the `cuda` test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segs_slam_tpu.core.camera import Camera as JCamera
from segs_slam_tpu.core.keyframe import Keyframe as JKeyframe
from segs_slam_tpu.ops import sh as jsh
from segs_slam_tpu.ops.rasterizer import RasterConfig as JRasterConfig
from segs_slam_tpu.ops.rasterizer import rasterize as j_rasterize
from segs_slam_tpu_torch.core import Camera, Keyframe
from segs_slam_tpu_torch.ops import sh
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig, rasterize
from segs_slam_tpu_torch.ops.rasterizer import blend as tblend
from test_sh import _numpy_eval_sh
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

W = H = 32
CFG = dict(tile=16, compact=256, kmax=8, chunk=64)


def _inputs(seed=2, n=128, degree=3):
    """Seeded gaussians in front of an identity camera, and SH coefficients
    whose colours stay above sh_to_color's clamp."""
    rng = np.random.default_rng(seed)
    means = rng.uniform([-1, -1, 2], [1, 1, 5], (n, 3)).astype(np.float32)
    scales = np.exp(rng.uniform(-3.5, -2.5, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.9, n).astype(np.float32)
    colors = rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32)
    shs = (0.03 * rng.normal(size=(n, sh.num_sh_coeffs(degree), 3))).astype(
        np.float32)
    shs[:, 0] = (colors - 0.5) / sh.C0
    return means, scales, quats, opac, colors, shs


def _cams():
    kw = dict(kf_id=0, quat=[1, 0, 0, 0], trans=[0, 0, 0])
    cam_kw = dict(camera_id=0, width=W, height=H, fx=30, fy=30, cx=W / 2,
                  cy=H / 2)
    return JKeyframe(camera=JCamera(**cam_kw), **kw), \
        Keyframe(camera=Camera(**cam_kw), **kw)


def _port_rasterize(args, colors, shs=None, degree=3, campos=None,
                    device="cpu"):
    _, kf = _cams()
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return rasterize(*args, colors, t(kf.world_view_transform),
                     t(kf.full_proj_transform), W, H, kf.camera.tan_fovx,
                     kf.camera.tan_fovy, torch.zeros(3, device=device),
                     config=RasterConfig(**CFG), shs=shs, sh_degree=degree,
                     campos=campos)


def test_eval_sh_matches_oracle_and_jax():
    rng = np.random.default_rng(0)
    n = 64
    for deg in range(5):
        k = sh.num_sh_coeffs(deg)
        coeffs = rng.normal(size=(n, k, 3)).astype(np.float32)
        dirs = rng.normal(size=(n, 3))
        dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(
            np.float32)
        got = sh.eval_sh(deg, torch.from_numpy(coeffs),
                         torch.from_numpy(dirs)).numpy()
        ref = np.asarray(jsh.eval_sh(deg, jnp.asarray(coeffs),
                                     jnp.asarray(dirs)))
        np.testing.assert_allclose(got, ref, atol=2e-6)
        if deg < 4:
            np.testing.assert_allclose(got, _numpy_eval_sh(deg, coeffs, dirs),
                                       atol=2e-5)
    with pytest.raises(ValueError):
        sh.eval_sh(5, torch.zeros(1, 36, 3), torch.zeros(1, 3))


def test_rgb_sh_roundtrip():
    rgb = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (10, 3))
                           .astype(np.float32))
    np.testing.assert_allclose(sh.sh_to_rgb(sh.rgb_to_sh(rgb)).numpy(),
                               rgb.numpy(), atol=1e-6)
    np.testing.assert_allclose(
        sh.rgb_to_sh(rgb).numpy(),
        np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb.numpy()))), atol=1e-6)


def test_rasterize_sh_deg0_matches_precomp():
    """Degree-0 SH with DC = RGB2SH(c) renders as colours c do."""
    means, scales, quats, opac, colors, _ = _inputs()
    args = [torch.from_numpy(x) for x in (means, scales, quats, opac)]
    img_pre = _port_rasterize(args, torch.from_numpy(colors))["image"]
    dc = sh.rgb_to_sh(torch.from_numpy(colors))[:, None, :]
    img_sh = _port_rasterize(args, torch.zeros(len(means), 3), shs=dc,
                             degree=0)["image"]
    assert float(img_pre.max()) > 0.1
    np.testing.assert_allclose(img_sh.numpy(), img_pre.numpy(), atol=1e-5)


def test_sh_view_dependence():
    """A degree-1 lobe changes colour with the viewing direction, as in
    JAX."""
    coeffs = np.zeros((1, 4, 3), np.float32)
    coeffs[0, 0] = 0.5
    coeffs[0, 3] = 1.0  # x lobe
    c = [sh.sh_to_color(1, torch.from_numpy(coeffs), torch.zeros(1, 3),
                        torch.tensor(p)) for p in ([-2.0, 0, 0], [2.0, 0, 0])]
    assert not np.allclose(c[0].numpy(), c[1].numpy())
    ref = jsh.sh_to_color(1, jnp.asarray(coeffs), jnp.zeros((1, 3)),
                          jnp.asarray([-2.0, 0, 0]))
    np.testing.assert_allclose(c[0].numpy(), np.asarray(ref), atol=1e-6)


def test_rasterize_sh_matches_jax():
    """rasterize(shs=...) at degree 3, campos derived from the view: the
    image within 2e-4 and the gradients of a seeded cotangent with respect
    to the SH coefficients and the means within 2e-4 of their largest,
    against JAX (Pallas in interpret mode); the derived campos is the
    camera centre, so passing that centre gives the same image."""
    means, scales, quats, opac, colors, shs = _inputs(seed=5, n=64)
    cot = np.random.default_rng(9).normal(size=(3, H, W)).astype(np.float32)
    jkf, kf = _cams()

    def jloss(sh_, m):
        out = j_rasterize(
            m, jnp.asarray(scales), jnp.asarray(quats), jnp.asarray(opac),
            jnp.zeros((len(means), 3)),
            jnp.asarray(jkf.world_view_transform),
            jnp.asarray(jkf.full_proj_transform), W, H,
            jkf.camera.tan_fovx, jkf.camera.tan_fovy, jnp.zeros(3),
            config=JRasterConfig(**CFG), interpret=True, shs=sh_,
            sh_degree=3)
        return jnp.sum(out["image"] * cot), out["image"]

    (_, jimg), jgrads = jax.value_and_grad(jloss, argnums=(0, 1),
                                           has_aux=True)(
        jnp.asarray(shs), jnp.asarray(means))

    t_sh = torch.from_numpy(shs).requires_grad_()
    t_means = torch.from_numpy(means).requires_grad_()
    args = [t_means] + [torch.from_numpy(x) for x in (scales, quats, opac)]
    img = _port_rasterize(args, torch.zeros(len(means), 3), shs=t_sh)["image"]
    (img * torch.from_numpy(cot)).sum().backward()

    assert float(img.detach().max()) > 0.1
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg),
                               atol=2e-4)
    for got, ref in zip((t_sh.grad, t_means.grad), jgrads):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        assert scale > 0
        np.testing.assert_allclose(got.numpy() / scale, ref / scale,
                                   atol=2e-4)
    with torch.no_grad():
        given = _port_rasterize(
            args, torch.zeros(len(means), 3), shs=t_sh,
            campos=torch.as_tensor(kf.camera_center))["image"]
    torch.testing.assert_close(given, img.detach(), rtol=0, atol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 and K2 are CUDA C++ with no "
                    "CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sh_rasterize_on_card_matches_cpu(cuda_device):
    """rasterize(shs=...) forward and backward through K1 and K2 on the
    card against the CPU path's plain versions."""
    means, scales, quats, opac, _, shs = _inputs(seed=5)
    cot = torch.from_numpy(np.random.default_rng(9).normal(
        size=(3, H, W)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda_device):
        before = tblend.blend_backward_cuda.launches
        t_sh = torch.tensor(shs, device=dev, requires_grad=True)
        t_means = torch.tensor(means, device=dev, requires_grad=True)
        args = [t_means] + [torch.tensor(x, device=dev)
                            for x in (scales, quats, opac)]
        img = _port_rasterize(args, torch.zeros(len(means), 3, device=dev),
                              shs=t_sh, device=dev)["image"]
        (img * cot.to(dev)).sum().backward()
        out[str(dev)] = [x.detach().cpu() for x in
                         (img, t_sh.grad, t_means.grad)]
        if dev != "cpu":
            assert tblend.blend_backward_cuda.launches == before + 1
    (img_c, *grads_c), (img_g, *grads_g) = out.values()
    np.testing.assert_allclose(img_g.numpy(), img_c.numpy(), atol=2e-4)
    for g, c in zip(grads_g, grads_c):
        scale = float(c.abs().max())
        np.testing.assert_allclose(g.numpy() / scale, c.numpy() / scale,
                                   atol=2e-4)
