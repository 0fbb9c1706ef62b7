"""The exact binning (RasterConfig compact = kmax = 0: no compaction cap,
no footprint clamp) against the plain reference
`port_bench/reference_unbounded.py`, on the CPU at small sizes: images,
losses and gradients; footprints over 31 tiles and more gaussians than a
compaction holds; the bounded routes' bits unchanged; train_colmap on the
route. On the card (`cuda`): K1 / K2 on tile lists thousands long, K5
without the clamp against the eager chain, and K5 with it, bit for bit."""

import hashlib
import importlib

import numpy as np
import pytest
import torch

from port_bench import reference as ref
from port_bench import reference_unbounded as ru
from segs_slam_tpu_torch.core import Camera, Keyframe
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig, rasterize
from segs_slam_tpu_torch.ops.rasterizer import binning
from segs_slam_tpu_torch.ops.rasterizer import blend as tblend
from segs_slam_tpu_torch.ops.rasterizer import preprocess as tpre
from segs_slam_tpu_torch.utils import tracing
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

trast = importlib.import_module("segs_slam_tpu_torch.ops.rasterizer.rasterize")

EXACT = RasterConfig(tile=16, compact=0, kmax=0, chunk=256)
# the raster dicts the reference reads
REF_RC = {"tile": 16, "near": 0.2, "alpha_min": 1.0 / 255.0,
          "alpha_clamp": 0.99, "transmittance_min": 1e-4, "kmax": 0}


def _scene(n=3000, big=300, w=128, h=96, seed=0):
    """n seeded gaussians before a keyframe's camera, the first `big` of
    them large and near, so that their footprints cover far more than 31
    of the view's 48 tiles. Returns (means, scales, quats, opac, colors,
    keyframe, w, h) as float32 tensors and the keyframe."""
    rng = np.random.default_rng(seed)
    cam = Camera(camera_id=0, width=w, height=h, fx=0.9 * w, fy=0.9 * w,
                 cx=w / 2, cy=h / 2)
    kf = Keyframe(kf_id=0, camera=cam, quat=[0.99, 0.05, -0.08, 0.03],
                  trans=[0.1, -0.05, 0.2])
    z = rng.uniform(1.5, 6.0, n)
    u = rng.uniform(-0.6, 0.6, (n, 2))
    z[:big] = rng.uniform(0.8, 1.6, big)
    pc = np.stack([u[:, 0] * z, u[:, 1] * z, z], -1)
    means = (pc - kf.trans) @ kf.rotation_matrix()
    scales = np.exp(rng.uniform(-4.0, -2.5, (n, 3)))
    scales[:big] = np.exp(rng.uniform(-1.6, -1.0, (big, 3)))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.05, 0.9, n)
    colors = rng.uniform(0, 1, (n, 3))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    return [f32(x) for x in (means, scales, quats, opac, colors)], kf, w, h


def _cam(kf):
    return {"world_view_transform": torch.as_tensor(kf.world_view_transform),
            "full_proj_transform": torch.as_tensor(kf.full_proj_transform),
            "tan_fovx": torch.tensor(np.float32(kf.camera.tan_fovx)),
            "tan_fovy": torch.tensor(np.float32(kf.camera.tan_fovy))}


def _port_image(x, kf, w, h, rc, bg):
    out = rasterize(*x, torch.as_tensor(kf.world_view_transform),
                    torch.as_tensor(kf.full_proj_transform), w, h,
                    np.float32(kf.camera.tan_fovx),
                    np.float32(kf.camera.tan_fovy), bg, config=rc)
    return out


def _reference_image(x, kf, w, h, bg):
    means, scales, quats, opac, colors = x
    p = ru.project(means, ref.cov3d(scales, quats), _cam(kf), w, h, REF_RC,
                   torch.ones(means.shape[0], dtype=torch.bool))
    feat = torch.cat([p["mean2d"].T, p["conic"].T, opac[None], colors.T])
    gid, tile = ru.all_pairs(p, opac, ref.grid(REF_RC, w, h)[0])
    return ru.blend(feat, p["depth"], gid, tile, REF_RC, bg, w, h), p, gid


def test_exact_route_matches_the_reference():
    """The exact route's image and the gradients of a loss of it (the
    means, scales, rotations, opacities, colours) against the reference's
    autograd, on a view where some footprints cover over 31 tiles and the
    alive gaussians outnumber a bounded compaction of 1,024; the bounded
    route (compact 1,024, kmax 8) renders another image."""
    x, kf, w, h = _scene()
    bg = torch.tensor([0.1, 0.2, 0.3])
    target = torch.rand(3, h, w, generator=torch.Generator().manual_seed(1))

    def grads(image_fn):
        leaves = [t.clone().requires_grad_() for t in x]
        img = image_fn(leaves)
        loss = ((img - target) ** 2).sum()
        return img.detach(), float(loss), torch.autograd.grad(loss, leaves)

    img, loss, g = grads(
        lambda v: _port_image(v, kf, w, h, EXACT, bg)["image"])
    img_r, loss_r, g_r = grads(
        lambda v: _reference_image(v, kf, w, h, bg)[0])
    _, p, gid = _reference_image(x, kf, w, h, bg)
    assert int(p["touched"].max()) > 31
    assert int(p["alive"].sum()) > 1024 and gid.shape[0] > 8 * 1024
    assert (img - img_r).abs().max() < 2e-5
    assert abs(loss - loss_r) / loss_r < 1e-6
    for name, a, b in zip(("means", "scales", "quats", "opac", "colors"),
                          g, g_r):
        gap = float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
        assert gap < 1e-4, (name, gap)
    bounded = RasterConfig(tile=16, compact=1024, kmax=8, chunk=256)
    with torch.no_grad():
        img_b = _port_image(x, kf, w, h, bounded, bg)["image"]
    assert (img_b - img_r).abs().max() > 0.05


def test_exact_route_keeps_more_gaussians_than_the_largest_compact():
    """Over 65,536 alive gaussians in one view, more than the apps'
    compaction of 2^16 holds: the exact route's image equals the
    reference's."""
    x, kf, w, h = _scene(n=90_000, big=50, seed=5)
    x[3] = x[3] * 0.3
    bg = torch.tensor([0.3, 0.2, 0.1])
    with torch.no_grad():
        img = _port_image(x, kf, w, h, EXACT, bg)["image"]
        img_r, p, _ = _reference_image(x, kf, w, h, bg)
    assert int(p["alive"].sum()) > 1 << 16
    assert (img - img_r).abs().max() < 2e-5


def test_exact_binning_keeps_every_pair_and_counts_them():
    """bin_exact keeps every tile of every alive rect, whole, in (tile,
    depth) order with the tile ranges over them; the route counts its pairs
    and gaussians while tracing, nothing dropped and no footprint
    truncated."""
    x, kf, w, h = _scene(n=800, big=100)
    with torch.no_grad():
        proj, feats, aux = trast.project(
            *x, torch.as_tensor(kf.world_view_transform),
            torch.as_tensor(kf.full_proj_transform), w, h,
            np.float32(kf.camera.tan_fovx), np.float32(kf.camera.tan_fovy),
            EXACT)
    tx, ty = EXACT.grid(w, h)
    b, num_valid = binning.bin_exact(feats, aux, tx, ty)
    alive = aux["alive"]
    assert int(num_valid) == int(alive.sum())
    assert int(b.num_instances) == int(aux["touched"][alive].sum()) \
        == b.gid_sorted.shape[0]
    assert int(aux["touched"].max()) > 31 and int(proj.kmax_truncated) == 0
    assert torch.equal(aux["touched"], torch.where(
        alive, aux["rect_w"] * (proj.rect_max[:, 1] - proj.rect_min[:, 1]),
        0))
    tile = torch.repeat_interleave(torch.arange(tx * ty),
                                   (b.tile_stop - b.tile_start).long())
    assert torch.equal(b.tile_stop[:-1], b.tile_start[1:])
    gid = b.gid_sorted.long()
    # each pair's tile lies in its gaussian's rect; each (tile) run is in
    # depth order
    col, row = tile % tx, tile // tx
    assert ((col >= aux["rect_min_x"][gid]) & (col < proj.rect_max[gid, 0])
            & (row >= aux["rect_min_y"][gid])
            & (row < proj.rect_max[gid, 1])).all()
    d = b.feats_sorted[9]
    same = tile[1:] == tile[:-1]
    assert (d[1:][same] >= d[:-1][same]).all()
    assert torch.equal(b.feats_sorted[:9], feats[:, gid])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tracing.reset()
        _port_image(x, kf, w, h, EXACT, torch.zeros(3))
        counts = tracing.read()["counts"]
    tracing.reset()
    assert counts["render.pairs"] == int(b.num_instances)
    assert counts["render.binned_gaussians"] == int(num_valid)
    assert counts["render.compact_dropped"] == 0
    assert counts["render.kmax_truncated"] == 0


def test_exact_config_checks():
    """compact and kmax are 0 together; the exact binning takes no tiers,
    packing or pre-compaction, has no eval variant and no packed eval
    blend."""
    for kw in (dict(compact=0), dict(kmax=0), dict(compact=0, kmax=0,
                                                   ksmall=2, nlarge=8),
               dict(compact=0, kmax=0, packed_train=True),
               dict(compact=0, kmax=0, kanchor=4, kgroup=10)):
        with pytest.raises(ValueError):
            RasterConfig(**kw)
    assert EXACT.exact and not RasterConfig().exact
    assert EXACT.eval_variant(640, 480) is EXACT
    x, kf, w, h = _scene(n=50, big=5)
    with torch.no_grad():
        _, feats, aux = trast.project(
            *x, torch.as_tensor(kf.world_view_transform),
            torch.as_tensor(kf.full_proj_transform), w, h,
            np.float32(kf.camera.tan_fovx), np.float32(kf.camera.tan_fovy),
            EXACT)
    with pytest.raises(ValueError, match="exact"):
        tblend.binned_blend_eval(feats, aux, torch.zeros(3), EXACT,
                                 *EXACT.grid(w, h))


# The bounded routes' outputs on `_scene`, digested by the tree before the
# exact binning was added: the projection (its every field) and the f32,
# packed-training and eval binnings, at configurations with footprints over
# kmax and more alive gaussians than compact.
BOUNDED_DIGEST = ("f0b3b929111e5d2f4c61f434ad5ad387"
                  "fc436b801bd8d252da944b6631c8fb9a")


def _bounded_digest() -> str:
    x, kf, w, h = _scene()
    configs = [RasterConfig(tile=16, compact=1024, kmax=8, chunk=256,
                            ksmall=4, nlarge=128),
               RasterConfig(tile=16, compact=2048, kmax=16, chunk=256),
               RasterConfig(tile=16, compact=1024, kmax=8, chunk=256,
                            ksmall=4, nlarge=128, packed_train=True)]
    hsh = hashlib.sha256()

    def add(t):
        hsh.update(t.contiguous().numpy().tobytes())

    for rc in configs + [configs[0].eval_variant(w, h)]:
        with torch.no_grad():
            proj, feats, aux = trast.project(
                *x, torch.as_tensor(kf.world_view_transform),
                torch.as_tensor(kf.full_proj_transform), w, h,
                np.float32(kf.camera.tan_fovx),
                np.float32(kf.camera.tan_fovy), rc)
            for t in proj:
                add(t)
            tx, ty = rc.grid(w, h)
            if rc.sel_direct:
                outs = binning.bin_eval_direct(feats, aux, tx, ty, rc,
                                               return_packed=True)
            elif rc.packed_train:
                outs = binning.expand_and_sort_packed_train(
                    binning.compact_gaussians_packed(feats, aux, rc,
                                                     with_orig=True),
                    tx, ty, rc)
            else:
                outs = binning.expand_and_sort(
                    binning.compact_gaussians(feats, aux, rc), tx, ty, rc)
            for t in outs:
                add(t)
    return hsh.hexdigest()


def test_bounded_routes_unchanged_bit_for_bit():
    """Every bounded configuration's projection and binning give the bits
    they gave before the exact binning existed."""
    assert _bounded_digest() == BOUNDED_DIGEST


def test_train_colmap_on_the_exact_route(tmp_path):
    """train_colmap --compact 0 --kmax 0 on a tiny synthetic COLMAP scene:
    every training blend takes the exact binning, and the evaluation
    renders through it too (f32 rows, K1's plain version)."""
    from segs_slam_tpu_torch.apps import train_colmap
    from segs_slam_tpu_torch.utils import make_colmap_dataset as maker

    scene = tmp_path / "scene"
    maker.main(["--out", str(scene), "--views", "4", "--width", "64",
                "--height", "48", "--gaussians", "300", "--sparse-points",
                "120", "--device", "cpu"])
    before = dict(tblend.train_binnings)
    res = train_colmap.main([
        "--scene", str(scene), "--iters", "4", "--capacity", "512",
        "--compact", "0", "--kmax", "0", "--log-every", "2",
        "--device", "cpu"])
    t = res["trainer"]
    assert t.raster_config.exact and res["iterations"] == 4
    assert np.isfinite(res["psnr"])
    assert not t.eval_renderer().packed
    made = {k: tblend.train_binnings[k] - before[k] for k in before}
    # 4 iterations and one eval render a keyframe, all exact
    assert made == {"packed": 0, "f32": 0, "exact": 4 + 4}


# On the card.

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K1, K2 and K5 are CUDA C++ with "
                    "no CPU mode)")
    return torch.device("cuda")


def _card_view(dev, n=200_000, w=640, h=480):
    """An exact-binned view of `n` gaussians on the card, dense enough that
    its tiles' lists run to thousands: (feats_sorted, tile_start,
    tile_stop, tiles_x)."""
    x, kf, _, _ = _scene(n=n, big=n // 20, w=w, h=h, seed=3)
    x = [t.to(dev) for t in x]
    x[3] = x[3] * 0.2  # faint: pixels latch late, lists are walked deep
    with torch.no_grad():
        _, feats, aux = trast.project(
            *x, torch.as_tensor(kf.world_view_transform, device=dev),
            torch.as_tensor(kf.full_proj_transform, device=dev), w, h,
            np.float32(kf.camera.tan_fovx), np.float32(kf.camera.tan_fovy),
            EXACT)
        tx, ty = EXACT.grid(w, h)
        b, _ = binning.bin_exact(feats, aux, tx, ty)
    return b.feats_sorted, b.tile_start, b.tile_stop, tx


@pytest.mark.cuda
def test_kernels_on_tile_lists_thousands_long(cuda_device):
    """K1 and K2 against their plain versions on the card on an exact-
    binned view whose longest tile lists exceed 2,000 instances."""
    f, start, stop, tx = _card_view(cuda_device)
    assert int((stop - start).max()) > 2000
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda_device)
    got = tblend.blend_forward_cuda(f, start, stop, bg, tx, EXACT)
    ref_fwd = tblend.blend_forward_reference(f, start, stop, bg, tx, EXACT)
    torch.cuda.synchronize()
    nc_ok = got[3] == ref_fwd[3]
    assert nc_ok.float().mean() >= 0.9999
    for a, b in zip(got[:2], ref_fwd[:2]):
        assert ((a - b).abs() <= 2e-4)[nc_ok.expand_as(b)].all()
    g = torch.Generator(device=cuda_device).manual_seed(2)
    nt = start.shape[0]
    cot = [torch.randn(nt, c, 256, generator=g, device=cuda_device)
           for c in (3, 1, 1)]
    args = (f, start, stop, bg, tx, EXACT, *cot, ref_fwd[1], ref_fwd[3])
    got_b = tblend.blend_backward_cuda(*args)
    ref_b = tblend.blend_backward_reference(*args)
    torch.cuda.synchronize()
    scale = ref_b.abs().amax(dim=1, keepdim=True).clamp(min=1e-12)
    assert ((got_b - ref_b).abs() / scale).max() < 2e-4


def _k5_against_chain(dev, rc, w=1297, h=840):
    x, kf, _, _ = _scene(n=1 << 18, big=1 << 14, w=w, h=h, seed=4)
    x = [t.to(dev) for t in x]
    cam = (torch.as_tensor(kf.world_view_transform, device=dev),
           torch.as_tensor(kf.full_proj_transform, device=dev), w, h,
           np.float32(kf.camera.tan_fovx), np.float32(kf.camera.tan_fovy))
    valid = torch.rand(x[0].shape[0], device=dev) > 0.1
    proj, feats, aux = trast.preprocess_cuda(x[0], x[1], x[2], *cam, rc,
                                             valid, x[3], x[4])
    mask = trast.preprocess_cuda(x[0], x[1], x[2], *cam, rc, valid)
    chain = tpre.preprocess_gaussians(x[0], tpre.compute_cov3d(x[1], x[2]),
                                      *cam, rc, valid_in=valid)
    feats_c, aux_c = trast.blend_inputs(chain, x[3], x[4])
    torch.cuda.synchronize()
    for name in tpre.GaussianProjection._fields:
        assert torch.equal(getattr(proj, name), getattr(chain, name)), name
    assert torch.equal(feats, feats_c)
    for name in aux:
        assert torch.equal(aux[name], aux_c[name]), name
    assert torch.equal(mask, chain.radius > 0)
    return chain


@pytest.mark.cuda
def test_k5_without_the_clamp_matches_the_chain(cuda_device):
    """K5 at kmax 0 (both entries) against the eager chain at kmax 0, bit
    for bit, at the garden configuration's 1297 x 840: whole rects, far
    over 31 tiles, none truncated."""
    chain = _k5_against_chain(cuda_device, EXACT)
    assert int(chain.tiles_touched.max()) > 31
    assert int(chain.kmax_truncated) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kmax", [8, 31])
def test_k5_with_the_clamp_still_matches_the_chain(cuda_device, kmax):
    """K5 at kmax 8 and 31 against the eager chain, bit for bit, on the
    same inputs, with footprints truncated."""
    rc = RasterConfig(tile=16, compact=1 << 16, kmax=kmax, chunk=256)
    chain = _k5_against_chain(cuda_device, rc)
    assert int(chain.kmax_truncated) > 1000
