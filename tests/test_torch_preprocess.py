"""Parity of the port's rasterizer preprocess with the JAX package: floats at
1e-5, integer footprints (radius, rects, tiles_touched, kmax_truncated)
equal. The route between kernel K5 and its plain twin, the eager chain, on
the CPU; on the card (`cuda`-marked), K5 against the chain bit for bit."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from segs_slam_tpu.core import Camera
from segs_slam_tpu.core.keyframe import Keyframe
from segs_slam_tpu.ops.rasterizer import preprocess as jpre
from segs_slam_tpu.ops.rasterizer import visible_filter as j_visible_filter
from segs_slam_tpu_torch.core import Camera as TCamera
from segs_slam_tpu_torch.core import Keyframe as TKeyframe
from segs_slam_tpu_torch.ops.rasterizer import preprocess as tpre
from segs_slam_tpu_torch.ops.rasterizer import visible_filter
from segs_slam_tpu_torch.utils import tracing
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

# the module, not the function the package exports under the same name
trast = importlib.import_module("segs_slam_tpu_torch.ops.rasterizer.rasterize")

W, H = 48, 32


def _scene(n=200, seed=0, big=0):
    rng = np.random.default_rng(seed)
    cam = Camera(camera_id=0, width=W, height=H, fx=40.0, fy=40.0,
                 cx=W / 2, cy=H / 2)
    kf = Keyframe(kf_id=0, camera=cam, quat=[0.99, 0.05, -0.08, 0.02],
                  trans=[0.1, -0.2, 0.3])
    means = rng.uniform([-2.0, -1.5, -1.0], [2.0, 1.5, 6.0], (n, 3))
    scales = np.exp(rng.uniform(-3.2, -1.8, (n, 3)))
    scales[:big] = np.exp(rng.uniform(-1.0, -0.5, (big, 3)))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    valid = rng.uniform(size=n) > 0.2
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return kf, f32(means), f32(scales), f32(quats), valid


def test_raster_config_checks_and_sizes():
    good = [dict(), dict(compact=256, kmax=8, ksmall=4, nlarge=64),
            dict(compact=512, kmax=16, ksmall=2, kmid=8, nmid=64, nlarge=32,
                 sel_direct=True, pack8=True),
            dict(kanchor=6, kgroup=10), dict(tile=8)]
    for kw in good:
        a, b = tpre.RasterConfig(**kw), jpre.RasterConfig(**kw)
        assert a.max_instances == b.max_instances, kw
        assert a.grid(W + 5, H) == b.grid(W + 5, H), kw
    bad = [dict(nmid=8), dict(ksmall=2, kmid=8, kmax=8, nmid=8, nlarge=4),
           dict(ksmall=2, kmid=4, kmax=8, nmid=8, nlarge=16), dict(kmid=4),
           dict(ksmall=4), dict(kanchor=10, kgroup=10),
           dict(sel_direct=True), dict(pack8=True)]
    for kw in bad:
        with pytest.raises(ValueError):
            jpre.RasterConfig(**kw)
        with pytest.raises(ValueError):
            tpre.RasterConfig(**kw)


def test_cov3d_cov2d_match_jax():
    kf, means, scales, quats, _ = _scene(seed=1)
    cam = kf.camera
    cov_j = jpre.compute_cov3d(jnp.asarray(scales), jnp.asarray(quats), 1.3)
    cov_t = tpre.compute_cov3d(torch.as_tensor(scales),
                               torch.as_tensor(quats), 1.3)
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j), rtol=1e-5,
                               atol=1e-7)
    focal = (cam.fx, cam.fy, cam.tan_fovx, cam.tan_fovy)
    c2_j = jpre.compute_cov2d(jnp.asarray(means), cov_j,
                              jnp.asarray(kf.world_view_transform), *focal)
    c2_t = tpre.compute_cov2d(torch.as_tensor(means),
                              torch.tensor(np.asarray(cov_j)),
                              torch.as_tensor(kf.world_view_transform),
                              *focal)
    np.testing.assert_allclose(c2_t.numpy(), np.asarray(c2_j), rtol=1e-5,
                               atol=1e-5)


def _compare_projection(pt, pj):
    for name in ("mean2d", "conic", "depth"):
        np.testing.assert_allclose(getattr(pt, name).numpy(),
                                   np.asarray(getattr(pj, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    for name in ("radius", "rect_min", "rect_max", "tiles_touched",
                 "kmax_truncated"):
        a, b = getattr(pt, name).numpy(), np.asarray(getattr(pj, name))
        assert a.dtype == b.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("kmax,big,tensor_fov,masked", [
    (64, 0, False, False),   # no truncation
    (4, 20, False, True),    # kmax rect clamp active, padded buffer mask
    (4, 40, True, True),     # tan_fov as f32 0-d arrays (the render path)
])
def test_preprocess_matches_jax(kmax, big, tensor_fov, masked):
    kf, means, scales, quats, valid = _scene(seed=kmax, big=big)
    cov = np.asarray(jpre.compute_cov3d(jnp.asarray(scales),
                                        jnp.asarray(quats)))
    cfg_j = jpre.RasterConfig(tile=16, compact=256, kmax=kmax, chunk=64)
    cfg_t = tpre.RasterConfig(tile=16, compact=256, kmax=kmax, chunk=64)
    tan = (kf.camera.tan_fovx, kf.camera.tan_fovy)
    if tensor_fov:
        tan_j = tuple(jnp.asarray(np.float32(x)) for x in tan)
        tan_t = tuple(torch.tensor(np.float32(x)) for x in tan)
    else:
        tan_j = tan_t = tan
    pj = jpre.preprocess_gaussians(
        jnp.asarray(means), jnp.asarray(cov),
        jnp.asarray(kf.world_view_transform),
        jnp.asarray(kf.full_proj_transform), W, H, *tan_j, cfg_j,
        valid_in=jnp.asarray(valid) if masked else None)
    pt = tpre.preprocess_gaussians(
        torch.as_tensor(means), torch.as_tensor(cov),
        torch.as_tensor(kf.world_view_transform),
        torch.as_tensor(kf.full_proj_transform), W, H, *tan_t, cfg_t,
        valid_in=torch.as_tensor(valid) if masked else None)
    _compare_projection(pt, pj)
    assert int(pt.radius.gt(0).sum()) > 20  # the scene is not all culled
    if big:
        assert int(pt.kmax_truncated) > 0


def test_to_int32_matches_xla_conversion():
    x = np.array([0.5, -0.5, -1.7, 2.9, 3e9, -3e9, np.inf, -np.inf, np.nan],
                 np.float32)
    ref = np.asarray(jnp.asarray(x).astype(jnp.int32))
    np.testing.assert_array_equal(tpre.to_int32(torch.as_tensor(x)).numpy(),
                                  ref)


def test_visible_filter_matches_jax():
    kf, means, scales, quats, valid = _scene(seed=5)
    means[:10, 2] = -1.0
    common = (W, H, kf.camera.tan_fovx, kf.camera.tan_fovy)
    ref = j_visible_filter(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats),
        jnp.asarray(kf.world_view_transform),
        jnp.asarray(kf.full_proj_transform), *common,
        config=jpre.RasterConfig(), valid=jnp.asarray(valid))
    ours = visible_filter(
        torch.as_tensor(means), torch.as_tensor(scales),
        torch.as_tensor(quats), torch.as_tensor(kf.world_view_transform),
        torch.as_tensor(kf.full_proj_transform), *common,
        config=tpre.RasterConfig(), valid=torch.as_tensor(valid))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert not ours[:10].any() and ours.any()


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device: the route predicate reads
    only devices, dtypes and requires_grad."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


# project's float inputs in uses_preprocess_kernel's order, then the tan_fov
# tensors and mean2d_offset
_PROJECT_FLOATS = ("means3d", "scales", "rotations", "opacities", "colors",
                   "world_view_transform", "full_proj_transform",
                   "mean2d_offset")


def _route_inputs(dtype=None, on_card=True):
    n = 8
    shapes = {"means3d": (n, 3), "scales": (n, 3), "rotations": (n, 4),
              "opacities": (n,), "colors": (n, 3),
              "world_view_transform": (4, 4), "full_proj_transform": (4, 4),
              "mean2d_offset": (n, 2), "tan_fovx": (), "tan_fovy": ()}
    x = {k: torch.rand(s) for k, s in shapes.items()}
    x["valid"] = torch.ones(n, dtype=torch.bool)
    if on_card:
        x = {k: v.as_subclass(_OnCard) for k, v in x.items()}
    if dtype is not None:
        name, dt = dtype
        x[name] = x[name].to(dt).as_subclass(type(x[name]))
    return x


def _routes(x):
    """(project's route, visible_filter's route) for inputs x."""
    project = trast.uses_preprocess_kernel(
        [x[k] for k in (*_PROJECT_FLOATS[:7], "tan_fovx", "tan_fovy",
                        "mean2d_offset")], grad_free=True)
    prefilter = trast.uses_preprocess_kernel([x["means3d"]])
    return project, prefilter


def test_preprocess_route_takes_the_kernel_on_card_inputs():
    """The control of the cases below: inputs on a CUDA device take K5 in
    both calls, under grad mode as under no_grad, where no input requires
    a gradient; host tan_fov values too."""
    x = _route_inputs()
    assert _routes(x) == (True, True)
    with torch.no_grad():
        assert _routes(x) == (True, True)
    x["tan_fovx"], x["tan_fovy"] = np.float32(0.6), 0.45
    assert _routes(x) == (True, True)


def test_preprocess_route_keeps_the_chain_on_cpu_tensors():
    assert _routes(_route_inputs(on_card=False)) == (False, False)
    with torch.no_grad():
        assert _routes(_route_inputs(on_card=False)) == (False, False)


@pytest.mark.parametrize("name", [*_PROJECT_FLOATS, "tan_fovx", "tan_fovy"])
def test_preprocess_route_keeps_the_chain_where_a_gradient_is_asked(name):
    """Any one input that requires a gradient (world_view_transform alone,
    as pose refinement asks) keeps project on the autograd chain under
    grad mode; under no_grad it takes K5. The prefilter's mask carries no
    gradient, so it takes K5 either way."""
    x = _route_inputs()
    x[name].requires_grad_(True)
    assert _routes(x) == (False, True)
    with torch.no_grad():
        assert _routes(x) == (True, True)


@pytest.mark.parametrize("name,dtype", [
    ("means3d", torch.float64), ("scales", torch.float16),
    ("rotations", torch.float64), ("opacities", torch.bfloat16),
    ("colors", torch.float64), ("world_view_transform", torch.float64),
    ("full_proj_transform", torch.float64), ("mean2d_offset", torch.float64),
    ("tan_fovx", torch.float64), ("valid", torch.uint8)])
def test_preprocess_kernel_raises_on_other_dtypes(name, dtype):
    """K5 computes in float32 with a bool mask. On the card the route
    depends on the device alone, so project and visible_filter raise, naming
    the input, on any other type, before any launch: no input falls back to
    the chain (opacities, colours and mean2d_offset are project's only)."""
    x = _route_inputs((name, dtype))
    cam = (x["world_view_transform"], x["full_proj_transform"], W, H,
           x["tan_fovx"], x["tan_fovy"])
    cfg = tpre.RasterConfig()
    gauss = (x["means3d"], x["scales"], x["rotations"])
    with torch.no_grad(), pytest.raises(ValueError, match=name):
        trast.project(*gauss, x["opacities"], x["colors"], *cam, cfg,
                      x["valid"], x["mean2d_offset"])
    if name not in ("opacities", "colors", "mean2d_offset"):
        with pytest.raises(ValueError, match=name):
            visible_filter(*gauss, *cam, config=cfg, valid=x["valid"])


def test_preprocess_route_is_counted_under_a_profiler():
    """On the CPU, project and visible_filter take the chain, and a profiler
    session counts each call under render.preprocess_eager (none under
    render.preprocess_kernel); without a session nothing is counted."""
    kf, means, scales, quats, valid = _scene(seed=3)
    cfg = tpre.RasterConfig(tile=16, compact=256, kmax=4, chunk=64)
    args = [torch.as_tensor(a) for a in (means, scales, quats)]
    cam = (torch.as_tensor(kf.world_view_transform),
           torch.as_tensor(kf.full_proj_transform), W, H,
           kf.camera.tan_fovx, kf.camera.tan_fovy)
    n = means.shape[0]
    op, col = torch.rand(n), torch.rand(n, 3)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        trast.project(*args, op, col, *cam, cfg, torch.as_tensor(valid))
        visible_filter(*args, *cam, config=cfg, valid=torch.as_tensor(valid))
    counts = tracing.read()["counts"]
    tracing.reset()
    assert counts["render.preprocess_eager"] == 2
    assert "render.preprocess_kernel" not in counts
    trast.project(*args, op, col, *cam, cfg, torch.as_tensor(valid))
    assert tracing.read()["counts"] == {}


def test_preprocess_cuda_checks_its_inputs():
    """The K5 wrapper raises before any launch on a wrong shape or type,
    and on tensors off the card (it never falls back)."""
    n = 6
    good = dict(means3d=torch.rand(n, 3), scales=torch.rand(n, 3),
                rotations=torch.rand(n, 4),
                world_view_transform=torch.eye(4),
                full_proj_transform=torch.eye(4))
    cfg = tpre.RasterConfig()
    for name, bad in (("scales", torch.rand(n, 4)),
                      ("rotations", torch.rand(n, 3)),
                      ("means3d", torch.rand(n, 3, dtype=torch.float64)),
                      ("world_view_transform", torch.eye(3))):
        args = dict(good, **{name: bad})
        with pytest.raises(ValueError, match=name):
            trast.preprocess_cuda(**args, width=W, height=H, tan_fovx=0.5,
                                  tan_fovy=0.5, config=cfg)
    with pytest.raises(ValueError, match="colors"):
        trast.preprocess_cuda(**good, width=W, height=H, tan_fovx=0.5,
                              tan_fovy=0.5, config=cfg,
                              opacities=torch.rand(n),
                              colors=torch.rand(n, 4))
    with pytest.raises(ValueError, match="CUDA"):
        trast.preprocess_cuda(**good, width=W, height=H, tan_fovx=0.5,
                              tan_fovy=0.5, config=cfg)


# On the card: K5 against its plain twin on the card.

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K5 is CUDA C++ with no CPU mode)")
    return torch.device("cuda")


# the apps' raster defaults
_TRAIN_RC = tpre.RasterConfig(tile=16, compact=65536, kmax=8, chunk=256,
                              ksmall=4, nlarge=8192, packed_train=True)


def _card_inputs(width, height, dev, n=1 << 20, seed=0):
    """~10^6 seeded gaussians before a keyframe's camera, with the edge
    cases at fixed strides: behind the near plane and the camera, within
    1e-3 of near, exactly at the camera centre, far outside the 1.3 tan
    clamp, footprints far over kmax, zero scales, unnormalised quaternions,
    valid_in false, and NaN / +-inf in means, scales and quaternions."""
    rng = np.random.default_rng(seed)
    cam = TCamera(camera_id=0, width=width, height=height, fx=0.8 * width,
                  fy=0.8 * width, cx=width / 2, cy=height / 2)
    kf = TKeyframe(kf_id=0, camera=cam, quat=[0.98, 0.1, -0.15, 0.05],
                   trans=[0.3, -0.2, 0.5])
    idx = np.arange(n)
    z = rng.uniform(-1.0, 12.0, n)
    z[idx % 53 == 11] = 0.2 + rng.uniform(-1e-3, 1e-3, (idx % 53 == 11).sum())
    u = rng.uniform(-1.6, 1.6, (n, 2))
    far = idx % 97 == 0
    u[far] *= 4.0
    pc = np.stack([u[:, 0] * cam.tan_fovx * np.abs(z),
                   u[:, 1] * cam.tan_fovy * np.abs(z), z], -1)
    pc[idx % 101 == 1] = 0.0  # at the camera centre
    # camera -> world: p_w = R^T (p_c - t)
    means = (pc - kf.trans) @ kf.rotation_matrix()
    scales = np.exp(rng.uniform(-5.0, -1.0, (n, 3)))
    big = idx % 13 == 2
    scales[big] = np.exp(rng.uniform(0.0, 1.5, (big.sum(), 3)))
    scales[idx % 89 == 3] = 0.0
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    quats[idx % 7 == 4] *= rng.uniform(0.5, 2.0, ((idx % 7 == 4).sum(), 1))
    for k, (arr, col, v) in enumerate([
            (means, 0, np.nan), (means, 2, np.inf), (means, 1, -np.inf),
            (scales, 0, np.nan), (scales, 1, np.inf), (quats, 2, np.nan)]):
        arr[idx % 211 == 5 + k, col] = v
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return kf, {
        "means3d": f32(means), "scales": f32(scales), "rotations": f32(quats),
        "opacities": f32(rng.uniform(0, 1, n)),
        "colors": f32(rng.uniform(0, 1, (n, 3))),
        "valid": torch.as_tensor(rng.uniform(size=n) > 0.15, device=dev),
        "mean2d_offset": f32(rng.normal(0, 0.5, (n, 2))),
        "world_view_transform": f32(kf.world_view_transform),
        "full_proj_transform": f32(kf.full_proj_transform)}


def _assert_same_bits(got, ref, name):
    assert got.shape == ref.shape and got.dtype == ref.dtype, name
    if got.is_floating_point():
        g = got.contiguous()
        r = ref.contiguous()
        same = (g.view(torch.int32) == r.view(torch.int32)) | (
            torch.isnan(g) & torch.isnan(r))
    else:
        same = got == ref
    bad = (~same).nonzero()
    assert bad.shape[0] == 0, (name, bad.shape[0], bad[:4].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(640, 480), (1200, 680)])
@pytest.mark.parametrize("variant", ["train", "eval"])
@pytest.mark.parametrize("fov", ["device", "host"])
def test_preprocess_kernel_matches_the_chain_bit_for_bit(
        cuda_device, size, variant, fov):
    """K5's two entries against the eager chain on the card, on every
    output: mean2d, conic, depth, radius, the rects, tiles_touched,
    kmax_truncated, the nine blend rows and every aux array, and the
    prefilter mask. NaNs match NaNs; every other value bit for bit. With
    tan_fov as 0-d device tensors (the benchmark's cameras) and as
    np.float32 (keyframes'), the latter with mean2d_offset and a scale
    modifier."""
    width, height = size
    kf, x = _card_inputs(width, height, cuda_device)
    rc = _TRAIN_RC if variant == "train" else _TRAIN_RC.eval_variant(
        width, height)
    tans = (np.float32(kf.camera.tan_fovx), np.float32(kf.camera.tan_fovy))
    offset, mod = (x["mean2d_offset"], 1.3) if fov == "host" else (None, 1.0)
    if fov == "device":
        tans = tuple(torch.tensor(t, device=cuda_device) for t in tans)
    cam = (x["world_view_transform"], x["full_proj_transform"], width,
           height, *tans)
    gauss = (x["means3d"], x["scales"], x["rotations"])

    def chain(modifier):
        proj = tpre.preprocess_gaussians(
            x["means3d"], tpre.compute_cov3d(x["scales"], x["rotations"],
                                             modifier), *cam, rc,
            valid_in=x["valid"])
        return (proj, *trast.blend_inputs(proj, x["opacities"], x["colors"],
                                          offset))

    launches = trast.preprocess_cuda.launches
    proj, feats, aux = trast.preprocess_cuda(
        *gauss, *cam, rc, x["valid"], x["opacities"], x["colors"], offset,
        mod)
    mask = trast.preprocess_cuda(*gauss, *cam, rc, x["valid"])
    torch.cuda.synchronize()
    assert trast.preprocess_cuda.launches == launches + 2
    ref_proj, ref_feats, ref_aux = chain(mod)
    for name in tpre.GaussianProjection._fields:
        _assert_same_bits(getattr(proj, name), getattr(ref_proj, name), name)
    _assert_same_bits(feats, ref_feats, "feats")
    assert set(aux) == set(ref_aux)
    for name in aux:
        _assert_same_bits(aux[name], ref_aux[name], name)
    ref_mask = chain(1.0)[0].radius > 0
    _assert_same_bits(mask, ref_mask, "mask")
    # the cases are exercised
    alive = ref_proj.radius > 0
    assert int(alive.sum()) > 50_000 and int(ref_mask.sum()) > 50_000
    assert int(ref_proj.kmax_truncated) > 1_000
    assert torch.isnan(ref_feats).any() and not alive[~x["valid"]].any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tum_rgbd", "replica_rgbd"])
def test_eval_render_with_the_kernel_equals_the_chain(cuda_device, name):
    """EvalRenderer's image through K5 equals its image with the eager
    chain forced, bit for bit, on a seeded full-width map (2^16 anchors x
    10 offsets) at each benchmark configuration's size (640x480, 1200x680:
    the packed eval blend K3 and the f32 one K1), calibrated eval config,
    over a few orbit views; K5 launched twice a view."""
    from segs_slam_tpu_torch.tools import preprocess_ab

    scene = preprocess_ab.seeded_scene(name, cuda_device, n_views=6)

    def images():
        with torch.no_grad():
            return [scene.renderer(scene.state, scene.decoders, cam)
                    for cam in scene.cams]

    launches = trast.preprocess_cuda.launches
    with_kernel = images()
    assert trast.preprocess_cuda.launches == launches + 2 * len(scene.cams)
    with preprocess_ab.chain_forced():
        with_chain = images()
    assert trast.preprocess_cuda.launches == launches + 2 * len(scene.cams)
    for i, (a, b) in enumerate(zip(with_kernel, with_chain)):
        assert float(a.abs().max()) > 0.05, i  # the view sees the map
        assert torch.equal(a, b), (name, i)
