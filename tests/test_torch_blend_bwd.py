"""The port's blend backward (K2's plain version on the CPU, inside the
autograd.Function) against jax.vjp of the JAX package's binned_blend (Pallas
in interpret mode), and the port's rasterize gradients against JAX's and
against the port's dense autograd oracle.

Tolerance: 2e-4 after scaling each gradient by its largest magnitude (the
convention of tests/test_rasterizer.py:137-139). The sums are taken in
another order than JAX's chunked log-domain suffix products and its MXU
pixel-basis reductions, and scatter-adds add in no fixed order, so equality
is up to f32 rounding of sums over a tile's pixels and instances. The
kernel itself runs only on a card: see the `cuda` test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segs_slam_tpu.core import Camera
from segs_slam_tpu.core.keyframe import Keyframe
from segs_slam_tpu.ops.rasterizer import RasterConfig as JRasterConfig
from segs_slam_tpu.ops.rasterizer import preprocess as jpre
from segs_slam_tpu.ops.rasterizer import rasterize as j_rasterize
from segs_slam_tpu.ops.rasterizer.blend import binned_blend as j_binned_blend
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig, rasterize
from segs_slam_tpu_torch.ops.rasterizer import blend as tblend
from segs_slam_tpu_torch.ops.rasterizer.dense import rasterize_dense
from test_torch_blend import stress_tiles
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)


def _scene(name):
    """(means, scales, quats, opac, colors, bg, kf, W, H, config kwargs);
    opacities stay below the 0.99 clamp, where the dense oracle's autograd
    and the blend backward agree."""
    if name == "deep_stack":  # tests/test_rasterizer.py:202
        n_front, n_back = 40, 400
        n = n_front + n_back
        rng = np.random.default_rng(7)
        means = np.zeros((n, 3))
        means[:, 2] = np.linspace(2.0, 4.0, n)
        means[:, :2] = rng.normal(scale=0.01, size=(n, 2))
        scales = np.full((n, 3), 0.3)
        quats = np.tile(np.array([1.0, 0, 0, 0]), (n, 1))
        opac = np.concatenate([np.full(n_front, 0.9), np.full(n_back, 0.005)])
        colors = rng.uniform(0.2, 0.9, (n, 3))
        w = h = 32
        cam = Camera(camera_id=0, width=w, height=h, fx=30, fy=30, cx=16,
                     cy=16)
        cfg = dict(compact=512, kmax=4, chunk=128)
        bg = np.array([0.3, 0.5, 0.7])
    elif name == "dual_rate":  # tests/test_rasterizer.py:331
        rng = np.random.default_rng(13)
        n = 300
        means = rng.uniform([-1.2, -1.2, 2.0], [1.2, 1.2, 5.0], (n, 3))
        scales = np.exp(rng.uniform(-4.0, -3.0, (n, 3)))
        scales[:20] = np.exp(rng.uniform(-2.2, -1.6, (20, 3)))
        quats = rng.normal(size=(n, 4))
        opac = rng.uniform(0.3, 0.9, n)
        colors = rng.uniform(0, 1, (n, 3))
        w = h = 64
        cam = Camera(camera_id=0, width=w, height=h, fx=60, fy=60, cx=32,
                     cy=32)
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
    else:  # tests/test_rasterizer.py:_scene
        rng = np.random.default_rng(0 if name == "zero_bg" else 3)
        n = 40
        w, h = 48, 32
        cam = Camera(camera_id=0, width=w, height=h, fx=40.0, fy=40.0,
                     cx=w / 2, cy=h / 2)
        means = rng.uniform([-1.5, -1.0, 2.0], [1.5, 1.0, 6.0], size=(n, 3))
        scales = np.exp(rng.uniform(-3.2, -1.8, size=(n, 3)))
        quats = rng.normal(size=(n, 4))
        opac = rng.uniform(0.2, 0.95, size=(n,))
        colors = rng.uniform(0.0, 1.0, size=(n, 3))
        bg = np.zeros(3) if name == "zero_bg" else np.array([0.9, 0.5, 0.1])
        cfg = dict(compact=256, kmax=64, chunk=64)
    quats = quats / np.linalg.norm(quats, axis=1, keepdims=True)
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


def _assert_scaled_close(ours, ref, name, tol=2e-4):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert np.isfinite(ours).all(), name
    scale = np.abs(ref).max() + 1e-12
    np.testing.assert_allclose(ours / scale, ref / scale, atol=tol, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("name", ["zero_bg", "nonzero_bg", "deep_stack",
                                  "dual_rate", "latch_batches"])
def test_blend_backward_matches_jax_vjp(name):
    """All three cotangents (colour, final_T, expected depth) at once."""
    means, scales, quats, opac, colors, bg, kf, w, h, cfg_kw = _scene(name)
    cfg_j = jpre.RasterConfig(tile=16, **cfg_kw)
    cfg_t = RasterConfig(tile=16, **cfg_kw)
    feats, aux = _blend_inputs(means, scales, quats, opac, colors, kf, w, h,
                               cfg_j)
    tx, ty = cfg_t.grid(w, h)
    nt = tx * ty
    rng = np.random.default_rng(5)
    dcolor = rng.normal(size=(nt, 3, 256)).astype(np.float32)
    dfinal_t = rng.normal(size=(nt, 1, 256)).astype(np.float32)
    ddepth = (0.3 * rng.normal(size=(nt, 1, 256))).astype(np.float32)

    aux_j = {k: jnp.asarray(v) for k, v in aux.items() if k != "depth"}

    def j_fn(f, d, b):
        out = j_binned_blend(f, dict(aux_j, depth=d), b,
                             (cfg_j, tx, ty, 256, True))
        return out[0], out[1], out[2]

    _, vjp = jax.vjp(j_fn, tuple(jnp.asarray(f) for f in feats),
                     jnp.asarray(aux["depth"]), jnp.asarray(bg))
    j_df, j_dd, j_dbg = vjp((jnp.asarray(dcolor), jnp.asarray(dfinal_t),
                             jnp.asarray(ddepth)))

    f_t = torch.tensor(feats, requires_grad=True)
    d_t = torch.tensor(aux["depth"], requires_grad=True)
    bg_t = torch.tensor(bg, requires_grad=True)
    aux_t = {k: torch.tensor(v) for k, v in aux.items() if k != "depth"}
    out = tblend.binned_blend(f_t, dict(aux_t, depth=d_t), bg_t, cfg_t, tx,
                              ty)
    loss = ((out[0] * torch.as_tensor(dcolor)).sum()
            + (out[1] * torch.as_tensor(dfinal_t)).sum()
            + (out[2] * torch.as_tensor(ddepth)).sum())
    df, dd, dbg = torch.autograd.grad(loss, (f_t, d_t, bg_t))

    rows = ["mean2d.x", "mean2d.y", "conic.a", "conic.b", "conic.c",
            "opacity", "r", "g", "b"]
    for i, row in enumerate(rows):
        _assert_scaled_close(df[i].numpy(), j_df[i], row)
    _assert_scaled_close(dd.numpy(), j_dd, "depth")
    np.testing.assert_allclose(dbg.numpy(), np.asarray(j_dbg), rtol=1e-5,
                               atol=1e-4)
    assert np.abs(np.asarray(j_df[5])).max() > 0  # the scene has gradients


def _raster_common(kf, w, h, bg, cfg, torch_side):
    if torch_side:
        return dict(
            world_view_transform=torch.as_tensor(kf.world_view_transform),
            full_proj_transform=torch.as_tensor(kf.full_proj_transform),
            width=w, height=h, tan_fovx=kf.camera.tan_fovx,
            tan_fovy=kf.camera.tan_fovy, bg=torch.as_tensor(bg),
            config=RasterConfig(tile=16, **cfg))
    return dict(
        world_view_transform=jnp.asarray(kf.world_view_transform),
        full_proj_transform=jnp.asarray(kf.full_proj_transform),
        width=w, height=h, tan_fovx=kf.camera.tan_fovx,
        tan_fovy=kf.camera.tan_fovy, bg=jnp.asarray(bg),
        config=JRasterConfig(tile=16, **cfg))


def _combined_loss(out, target, target_d, lib):
    """Colour, normalised expected depth and final_T: every cotangent path
    (tests/test_rasterizer.py:387)."""
    opac_img = 1.0 - out["final_T"]
    if lib is torch:
        dnorm = out["depth_map"] / torch.maximum(opac_img,
                                                 torch.tensor(1e-6))
        dm = (opac_img > 0.5).float()
    else:
        dnorm = out["depth_map"] / jnp.maximum(opac_img, 1e-6)
        dm = (opac_img > 0.5).astype(jnp.float32)
    return ((out["image"] - target) ** 2).sum() \
        + ((dnorm - target_d) ** 2 * dm).sum() + (out["final_T"] ** 2).sum()


@pytest.mark.parametrize("name", ["nonzero_bg", "deep_stack"])
def test_rasterize_gradients_match_jax_and_dense_oracle(name):
    means, scales, quats, opac, colors, bg, kf, w, h, cfg = _scene(name)
    rng = np.random.default_rng(1)
    target = rng.uniform(size=(3, h, w)).astype(np.float32)
    target_d = rng.uniform(1.5, 4.0, (h, w)).astype(np.float32)
    offset = np.zeros((len(means), 2), np.float32)
    arrays = (means, scales, quats, opac, colors, offset)
    names = ["means3d", "scales", "rotations", "opacities", "colors",
             "mean2d_offset"]

    jc = _raster_common(kf, w, h, bg, cfg, torch_side=False)

    def j_loss(m, s, q, o, c, off):
        return _combined_loss(j_rasterize(m, s, q, o, c, mean2d_offset=off,
                                          interpret=True, **jc),
                              jnp.asarray(target), jnp.asarray(target_d), jnp)

    j_val, j_grads = jax.value_and_grad(j_loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in arrays))

    tc = _raster_common(kf, w, h, bg, cfg, torch_side=True)
    results = {}
    for which, fn in (("tile", rasterize), ("dense", rasterize_dense)):
        leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
        m, s, q, o, c, off = leaves
        loss = _combined_loss(fn(m, s, q, o, c, mean2d_offset=off, **tc),
                              torch.as_tensor(target),
                              torch.as_tensor(target_d), torch)
        results[which] = (float(loss.detach()),
                          torch.autograd.grad(loss, leaves))

    for which in ("tile", "dense"):
        val, grads = results[which]
        np.testing.assert_allclose(val, float(j_val), rtol=1e-5)
        for g, jg, n in zip(grads, j_grads, names):
            _assert_scaled_close(g.numpy(), jg, f"{which} {n}")
    for g, gd, n in zip(results["tile"][1], results["dense"][1], names):
        _assert_scaled_close(g.numpy(), gd.numpy(), f"tile vs dense {n}")


def test_blend_backward_dispatch_and_guards():
    cfg = RasterConfig(tile=16, compact=64, kmax=4, chunk=64)
    g = torch.Generator().manual_seed(0)
    feats = torch.rand(tblend.NFEAT, 32, generator=g)
    feats[0:2] *= 16
    start = torch.tensor([0, 10], dtype=torch.int32)
    stop = torch.tensor([10, 32], dtype=torch.int32)
    bg = torch.tensor([0.1, 0.2, 0.3])
    fwd = tblend.blend_forward(feats, start, stop, bg, 2, cfg)
    cot = (torch.rand(2, 3, 256, generator=g), torch.rand(2, 1, 256,
                                                          generator=g),
           torch.rand(2, 1, 256, generator=g))
    before = tblend.blend_backward_cuda.launches
    args = (feats, start, stop, bg, 2, cfg, *cot, fwd[1], fwd[3])
    got = tblend.blend_backward(*args)
    assert torch.equal(got, tblend.blend_backward_reference(*args))
    assert got.shape == feats.shape
    assert tblend.blend_backward_cuda.launches == before
    with pytest.raises(ValueError):  # the kernel wrapper never takes CPU
        tblend.blend_backward_cuda(*args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K2 is CUDA C++ with no CPU mode)")
    return torch.device("cuda")


def _assert_rows_close(got, ref):
    """Every gradient row within 1e-4 of its largest magnitude."""
    scale = ref.abs().amax(dim=1, keepdim=True) + 1e-12
    assert ((got.cpu() - ref.cpu()).abs() <= 1e-4 * scale.cpu()).all()


@pytest.mark.cuda
def test_backward_kernel_matches_plain_version(cuda_device, monkeypatch):
    """K2 against its plain version on random deep tile stacks and on the
    edge cases of test_torch_blend.stress_tiles (there on the card, with
    the forward's own final_T and n_contrib), at each pixels-a-thread
    instance: every gradient row within 1e-4 of its largest magnitude, and
    the columns outside every tile range or past a tile's largest
    n_contrib zero though the output is not zero-filled. Then rasterize
    gradients on the card against the CPU path."""
    g = torch.Generator().manual_seed(0)
    tx, ty = 6, 4
    counts = torch.randint(0, 1500, (tx * ty,), generator=g,
                           dtype=torch.int32)
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
    fwd = tblend.blend_forward_reference(f, start, stop, bg, tx, cfg)
    cot = (torch.randn(tx * ty, 3, 256, generator=g),
           torch.randn(tx * ty, 1, 256, generator=g),
           torch.randn(tx * ty, 1, 256, generator=g))
    args = (f, start, stop, bg, tx, cfg, *cot, fwd[1], fwd[3])
    ref = tblend.blend_backward_reference(*args)
    for p in tblend.KERNEL_PIXELS:  # each instance of the kernel
        monkeypatch.setattr(tblend, "_pixels_per_thread", lambda *_: p)
        got = tblend.blend_backward_cuda(
            *(a.to(cuda_device) if torch.is_tensor(a) else a for a in args))
        torch.cuda.synchronize()
        _assert_rows_close(got, ref)

    *stress, tx = stress_tiles(torch.Generator().manual_seed(1))
    f, start, stop = (x.to(cuda_device) for x in stress)
    bg = bg.to(cuda_device)
    nt = start.shape[0]
    fwd = tblend.blend_forward_reference(f, start, stop, bg, tx, cfg)
    cot = tuple(torch.randn(nt, c, 256, generator=g).to(cuda_device)
                for c in (3, 1, 1))
    args = (f, start, stop, bg, tx, cfg, *cot, fwd[1], fwd[3])
    ref = tblend.blend_backward_reference(*args)
    assert (ref[:, :3] == 0).all() and (ref[:, int(stop[-1]):] == 0).all()
    walked = torch.minimum(fwd[3].reshape(nt, -1).amax(1), stop - start)
    assert int((stop - start - walked).sum()) > 0  # columns past n_contrib
    for p in tblend.KERNEL_PIXELS:
        monkeypatch.setattr(tblend, "_pixels_per_thread", lambda *_: p)
        # garbage in the allocator's next block: the kernel must write zeros
        torch.full((tblend.NFEAT, f.shape[1]), float("nan"),
                   device=cuda_device)
        got = tblend.blend_backward_cuda(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        _assert_rows_close(got, ref)

    means, scales, quats, opac, colors, bg, kf, w, h, cfg_kw = _scene(
        "dual_rate")
    grads = []
    for dev in ("cpu", cuda_device):
        leaves = [torch.tensor(a, device=dev, requires_grad=True)
                  for a in (means, scales, quats, opac, colors)]
        out = rasterize(*leaves,
                        torch.as_tensor(kf.world_view_transform, device=dev),
                        torch.as_tensor(kf.full_proj_transform, device=dev),
                        w, h, kf.camera.tan_fovx, kf.camera.tan_fovy,
                        torch.as_tensor(bg, device=dev),
                        config=RasterConfig(tile=16, **cfg_kw))
        loss = (out["image"] ** 2).sum() + out["depth_map"].sum()
        grads.append([x.cpu() for x in torch.autograd.grad(loss, leaves)])
    for a, b in zip(*grads):
        scale = b.abs().max() + 1e-12
        assert ((a - b).abs() <= 2e-4 * scale).all()
