"""The port's blend (K1's plain version on the CPU) and rasterize against the
JAX package's binned_blend (Pallas in interpret mode) and the NumPy oracle of
the reference semantics. Image tolerance 2e-4 as in tests/test_rasterizer.py;
n_contrib exact. The kernel itself runs only on a card: see the `cuda` test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segs_slam_tpu.core import Camera
from segs_slam_tpu.core.keyframe import Keyframe
from segs_slam_tpu.ops.rasterizer import preprocess as jpre
from segs_slam_tpu.ops.rasterizer.blend import binned_blend as j_binned_blend
from segs_slam_tpu.ops.rasterizer.reference import render_reference
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig, rasterize
from segs_slam_tpu_torch.ops.rasterizer import blend as tblend


def _scene(name):
    """(means, scales, quats, opac, colors, bg, kf, W, H, config kwargs)."""
    if name == "deep_stack":  # tests/test_rasterizer.py:202
        n_front, n_back = 40, 400
        n = n_front + n_back
        rng = np.random.default_rng(7)
        means = np.zeros((n, 3), np.float32)
        means[:, 2] = np.linspace(2.0, 4.0, n)
        means[:, :2] = rng.normal(scale=0.01, size=(n, 2))
        scales = np.full((n, 3), 0.3, np.float32)
        quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
        opac = np.concatenate([np.full(n_front, 0.9, np.float32),
                               np.full(n_back, 0.005, np.float32)])
        colors = rng.uniform(0.2, 0.9, (n, 3)).astype(np.float32)
        w = h = 32
        cam = Camera(camera_id=0, width=w, height=h, fx=30, fy=30, cx=16,
                     cy=16)
        cfg = dict(compact=512, kmax=4, chunk=128)
        bg = np.zeros(3)
    elif name == "dual_rate":  # tests/test_rasterizer.py:331
        rng = np.random.default_rng(13)
        n = 300
        means = rng.uniform([-1.2, -1.2, 2.0], [1.2, 1.2, 5.0], (n, 3))
        scales = np.exp(rng.uniform(-4.0, -3.0, (n, 3)))
        scales[:20] = np.exp(rng.uniform(-2.2, -1.6, (20, 3)))
        quats = rng.normal(size=(n, 4))
        quats /= np.linalg.norm(quats, axis=1, keepdims=True)
        opac = rng.uniform(0.3, 0.9, n)
        colors = rng.uniform(0, 1, (n, 3))
        w = h = 96
        cam = Camera(camera_id=0, width=w, height=h, fx=90, fy=90, cx=48,
                     cy=48)
        cfg = dict(compact=512, kmax=16, chunk=128, ksmall=4, nlarge=64)
        bg = np.array([0.2, 0.4, 0.6])
    elif name == "latch_batches":
        # tiles of 300-770 instances, more than three of K1's and K2's
        # batches; the density falls from left to right, so pixels latch
        # anywhere from the first batch to the third, or never
        rng = np.random.default_rng(11)
        n = 1200
        z = rng.uniform(2.0, 6.0, n)
        means = np.stack([(rng.beta(1.0, 2.2, n) - 0.5) * z,
                          rng.uniform(-0.5, 0.5, n) * z, z], 1)
        scales = rng.uniform(0.02, 0.06, (n, 3)) * z[:, None]
        quats = rng.normal(size=(n, 4))
        quats /= np.linalg.norm(quats, axis=1, keepdims=True)
        opac = rng.uniform(0.3, 0.95, n)
        colors = rng.uniform(0, 1, (n, 3))
        w = h = 32
        cam = Camera(camera_id=0, width=w, height=h, fx=30, fy=30, cx=16,
                     cy=16)
        cfg = dict(compact=2048, kmax=4, chunk=128)
        bg = np.array([0.2, 0.4, 0.6])
    else:  # tests/test_rasterizer.py:_scene, seeds 0 and 3
        rng = np.random.default_rng(0 if name == "zero_bg" else 3)
        n = 60
        w, h = 48, 32
        cam = Camera(camera_id=0, width=w, height=h, fx=40.0, fy=40.0,
                     cx=w / 2, cy=h / 2)
        means = rng.uniform([-1.5, -1.0, 2.0], [1.5, 1.0, 6.0], size=(n, 3))
        scales = np.exp(rng.uniform(-3.2, -1.8, size=(n, 3)))
        quats = rng.normal(size=(n, 4))
        quats /= np.linalg.norm(quats, axis=1, keepdims=True)
        opac = rng.uniform(0.2, 0.95, size=(n,))
        colors = rng.uniform(0.0, 1.0, size=(n, 3))
        bg = np.zeros(3) if name == "zero_bg" else np.ones(3)
        cfg = dict(compact=256, kmax=64, chunk=64)
    kf = Keyframe(kf_id=0, camera=cam, quat=[1, 0, 0, 0], trans=[0, 0, 0])
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return (f32(means), f32(scales), f32(quats), f32(opac), f32(colors),
            f32(bg), kf, w, h, cfg)


def _blend_inputs(means, scales, quats, opac, colors, kf, w, h, cfg):
    """(feats [9, N], aux) as numpy from the JAX preprocess."""
    cov = jpre.compute_cov3d(jnp.asarray(scales), jnp.asarray(quats))
    proj = jpre.preprocess_gaussians(
        jnp.asarray(means), cov, jnp.asarray(kf.world_view_transform),
        jnp.asarray(kf.full_proj_transform), w, h, kf.camera.tan_fovx,
        kf.camera.tan_fovy, cfg)
    m2, con = np.asarray(proj.mean2d), np.asarray(proj.conic)
    feats = np.stack([m2[:, 0], m2[:, 1], con[:, 0], con[:, 1], con[:, 2],
                      opac, colors[:, 0], colors[:, 1], colors[:, 2]])
    rmin, rmax = np.asarray(proj.rect_min), np.asarray(proj.rect_max)
    aux = {"rect_min_x": rmin[:, 0], "rect_min_y": rmin[:, 1],
           "rect_w": rmax[:, 0] - rmin[:, 0],
           "touched": np.asarray(proj.tiles_touched),
           "depth": np.asarray(proj.depth),
           "alive": np.asarray(proj.radius) > 0}
    return feats.astype(np.float32), aux


@pytest.mark.parametrize("name", ["zero_bg", "nonzero_bg", "deep_stack",
                                  "dual_rate", "latch_batches"])
def test_binned_blend_matches_jax(name):
    means, scales, quats, opac, colors, bg, kf, w, h, cfg_kw = _scene(name)
    cfg_j = jpre.RasterConfig(tile=16, **cfg_kw)
    cfg_t = RasterConfig(tile=16, **cfg_kw)
    feats, aux = _blend_inputs(means, scales, quats, opac, colors, kf, w, h,
                               cfg_j)
    tx, ty = cfg_t.grid(w, h)
    ref = j_binned_blend(tuple(jnp.asarray(f) for f in feats),
                         {k: jnp.asarray(v) for k, v in aux.items()},
                         jnp.asarray(bg), (cfg_j, tx, ty, 256, True))
    with torch.inference_mode():
        ours = tblend.binned_blend(
            torch.as_tensor(feats),
            {k: torch.as_tensor(v) for k, v in aux.items()},
            torch.as_tensor(bg), cfg_t, tx, ty)
    for i, what in enumerate(("color", "final_T", "depth")):
        np.testing.assert_allclose(ours[i].numpy(), np.asarray(ref[i]),
                                   atol=2e-4, rtol=0, err_msg=what)
    np.testing.assert_array_equal(ours[3].numpy(), np.asarray(ref[3]))
    assert ours[3].dtype == torch.int32
    assert int(ours[4]) == int(ref[4]) and int(ours[5]) == int(ref[5])


@pytest.mark.parametrize("name", ["zero_bg", "nonzero_bg", "deep_stack"])
def test_rasterize_matches_oracle(name):
    means, scales, quats, opac, colors, bg, kf, w, h, cfg_kw = _scene(name)
    ref = render_reference(means, scales, quats, opac, colors,
                           kf.world_view_transform, kf.full_proj_transform,
                           w, h, kf.camera.tan_fovx, kf.camera.tan_fovy, bg)
    with torch.inference_mode():
        out = rasterize(
            *(torch.as_tensor(x) for x in (means, scales, quats, opac,
                                           colors)),
            torch.as_tensor(kf.world_view_transform),
            torch.as_tensor(kf.full_proj_transform), w, h,
            kf.camera.tan_fovx, kf.camera.tan_fovy, torch.as_tensor(bg),
            config=RasterConfig(tile=16, **cfg_kw))
    assert out["image"].shape == (3, h, w)
    np.testing.assert_allclose(out["image"].numpy(), ref["image"], atol=2e-4)
    np.testing.assert_allclose(out["final_T"].numpy(), ref["final_T"],
                               atol=2e-4)
    np.testing.assert_array_equal(out["radii"].numpy(), ref["radii"])
    np.testing.assert_array_equal(out["n_contrib"].numpy(), ref["n_contrib"])
    if name == "deep_stack":  # the latch: no resurrection past the front 40
        assert int(out["n_contrib"].max()) <= 40


def test_dual_rate_renders_like_single_rate():
    means, scales, quats, opac, colors, bg, kf, w, h, cfg_kw = _scene(
        "dual_rate")
    args = (*(torch.as_tensor(x) for x in (means, scales, quats, opac,
                                           colors)),
            torch.as_tensor(kf.world_view_transform),
            torch.as_tensor(kf.full_proj_transform), w, h,
            kf.camera.tan_fovx, kf.camera.tan_fovy, torch.as_tensor(bg))
    single = dict(cfg_kw, ksmall=0, nlarge=0)
    with torch.inference_mode():
        a = rasterize(*args, config=RasterConfig(**single))
        b = rasterize(*args, config=RasterConfig(**cfg_kw))
        c = rasterize(*args, config=RasterConfig(**dict(cfg_kw, nlarge=8)))
    np.testing.assert_allclose(b["image"].numpy(), a["image"].numpy(),
                               atol=1e-6)
    assert int(c["num_large"]) > 8 and torch.isfinite(c["image"]).all()


def test_blend_dispatch_and_guards():
    cfg = RasterConfig(tile=16, compact=64, kmax=4, chunk=64)
    feats = torch.rand(tblend.NFEAT, 32)
    start = torch.tensor([0, 10], dtype=torch.int32)
    stop = torch.tensor([10, 32], dtype=torch.int32)
    bg = torch.zeros(3)
    before = tblend.blend_forward_cuda.launches
    got = tblend.blend_forward(feats, start, stop, bg, 2, cfg)
    want = tblend.blend_forward_reference(feats, start, stop, bg, 2, cfg)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tblend.blend_forward_cuda.launches == before
    with pytest.raises(ValueError):  # the kernel wrapper never takes CPU
        tblend.blend_forward_cuda(feats, start, stop, bg, 2, cfg)

    n = 8
    pay = torch.rand(tblend.NPAY, n, requires_grad=True)
    aux = {"rect_min_x": torch.zeros(n, dtype=torch.int32),
           "rect_min_y": torch.zeros(n, dtype=torch.int32),
           "rect_w": torch.ones(n, dtype=torch.int32),
           "touched": torch.ones(n, dtype=torch.int32),
           "depth": torch.rand(n), "alive": torch.ones(n, dtype=torch.bool)}
    out = tblend.binned_blend(pay, aux, bg, cfg, 2, 1)  # differentiable now
    assert out[0].requires_grad and not out[3].requires_grad
    # the eval binnings are refused on the training path, as in JAX
    with pytest.raises(ValueError, match="sel_direct"):
        tblend.binned_blend(pay.detach(), aux, bg,
                            RasterConfig(compact=64, kmax=4, ksmall=2,
                                         nlarge=8, sel_direct=True), 2, 1)


def stress_tiles(g):
    """Binned inputs [10, NK] for the kernels' edge cases, 6 x 4 tiles of
    16: ranges that start anywhere (the first at 3, columns past the last
    stop), empty tiles, ranges of 1 to 1,000 instances whose last batch is
    partial, instances crowded into the left 10 columns of their tile so
    that pixels latch anywhere from the first batch to the eighth or never,
    and a fifth of the opacities at 1, where alpha meets the 0.99 clamp.
    Returns (feats, tile_start, tile_stop, tiles_x)."""
    tx, ty = 6, 4
    counts = torch.tensor([0, 1, 3, 127, 128, 129, 255, 257, 700, 0, 5, 1000,
                           385, 2, 0, 640, 64, 33, 511, 513, 900, 17, 300,
                           129], dtype=torch.int32)
    stop = (3 + torch.cumsum(counts, 0)).to(torch.int32)
    start = stop - counts
    tile = torch.repeat_interleave(torch.arange(tx * ty), counts.long())
    m = tile.numel()
    f = torch.zeros(tblend.NFEAT, int(stop[-1]) + 7)
    cols = slice(3, 3 + m)
    f[0, cols] = (tile % tx * 16).float() + 11 * torch.rand(m, generator=g) - 1
    f[1, cols] = (tile // tx * 16).float() + 18 * torch.rand(m, generator=g) \
        - 1
    f[2, cols], f[4, cols] = 0.1 + 0.5 * torch.rand(2, m, generator=g)
    f[3, cols] = 0.1 * (torch.rand(m, generator=g) - 0.5)
    op = 0.15 + 0.85 * torch.rand(m, generator=g)
    f[5, cols] = torch.where(torch.rand(m, generator=g) < 0.2, 1.0, op)
    f[6:9, cols] = torch.rand(3, m, generator=g)
    f[9, cols] = 10 * torch.rand(m, generator=g)
    return f, start, stop, tx


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1 is CUDA C++ with no CPU mode)")
    return torch.device("cuda")


def _assert_forward_close(got, ref):
    """n_contrib equal on >= 99.99 % of pixels; there, colour and final_T
    within 2e-4 and depth within rtol 1e-4."""
    nc_ok = got[3].cpu() == ref[3].cpu()
    assert nc_ok.float().mean() >= 0.9999
    for a, b in zip(got[:2], ref[:2]):
        assert ((a.cpu() - b.cpu()).abs() <= 2e-4)[nc_ok.expand_as(b)].all()
    torch.testing.assert_close(got[2].cpu()[nc_ok], ref[2].cpu()[nc_ok],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_kernel_matches_plain_version(cuda_device, monkeypatch):
    """K1 against its plain version on random deep tile stacks and on the
    edge cases of `stress_tiles` (there on the card, where the plain
    version's torch.exp is the kernel's expf), at each pixels-a-thread
    instance, and the whole rasterize on the card against the CPU path."""
    g = torch.Generator().manual_seed(0)
    tx, ty = 6, 4
    counts = torch.randint(0, 3000, (tx * ty,), generator=g, dtype=torch.int32)
    stop = torch.cumsum(counts, 0).to(torch.int32)
    start = stop - counts
    nk = int(stop[-1]) + 5
    f = torch.rand(tblend.NFEAT, nk, generator=g)
    f[0] *= tx * 16
    f[1] *= ty * 16
    f[2:5] = f[2:5] * torch.tensor([0.05, 0.01, 0.05])[:, None] \
        + torch.tensor([0.01, -0.005, 0.01])[:, None]
    f[5] *= 0.5
    f[9] *= 10
    bg = torch.tensor([0.1, 0.2, 0.3])
    cfg = RasterConfig(tile=16, compact=64, kmax=4)
    ref = tblend.blend_forward_reference(f, start, stop, bg, tx, cfg)
    for p in tblend.KERNEL_PIXELS:  # each instance of the kernel
        monkeypatch.setattr(tblend, "_pixels_per_thread", lambda *_: p)
        got = tblend.blend_forward_cuda(
            *(x.to(cuda_device) for x in (f, start, stop, bg)), tx, cfg)
        torch.cuda.synchronize()
        _assert_forward_close(got, ref)

    *stress, tx = stress_tiles(torch.Generator().manual_seed(1))
    f, start, stop = (x.to(cuda_device) for x in stress)
    bg = bg.to(cuda_device)
    ref = tblend.blend_forward_reference(f, start, stop, bg, tx, cfg)
    assert int(ref[3].max()) > 512 and (ref[1] < 1e-3).any()  # deep latches
    for p in tblend.KERNEL_PIXELS:  # each instance of the kernel
        monkeypatch.setattr(tblend, "_pixels_per_thread", lambda *_: p)
        got = tblend.blend_forward_cuda(f, start, stop, bg, tx, cfg)
        torch.cuda.synchronize()
        _assert_forward_close(got, ref)

    means, scales, quats, opac, colors, bg, kf, w, h, cfg_kw = _scene(
        "dual_rate")
    outs = []
    for dev in ("cpu", cuda_device):
        with torch.inference_mode():
            outs.append(rasterize(
                *(torch.as_tensor(x, device=dev) for x in (
                    means, scales, quats, opac, colors)),
                torch.as_tensor(kf.world_view_transform, device=dev),
                torch.as_tensor(kf.full_proj_transform, device=dev), w, h,
                kf.camera.tan_fovx, kf.camera.tan_fovy,
                torch.as_tensor(bg, device=dev),
                config=RasterConfig(**cfg_kw)))
    np.testing.assert_allclose(outs[1]["image"].cpu().numpy(),
                               outs[0]["image"].numpy(), atol=2e-4)
