"""Parity of the port's rasterizer preprocess with the JAX package: floats at
1e-5, integer footprints (radius, rects, tiles_touched, kmax_truncated)
equal. The route between kernels K5 / K6 and their plain twin, the eager
chain, on the CPU; on the card (`cuda`-marked), K5 against the chain bit for
bit and K6 against the chain's autograd gradient."""

import contextlib
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
from segs_slam_tpu_torch.tools import preprocess_ab
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
    only the device."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


# project's float inputs, then the tan_fov tensors
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


def test_preprocess_route_takes_the_kernel_on_card_inputs():
    """The route is the device of means3d alone: on a CUDA device the
    kernels, under grad mode as under no_grad, whatever asks a gradient."""
    x = _route_inputs()
    assert trast.uses_preprocess_kernel(x["means3d"])
    with torch.no_grad():
        assert trast.uses_preprocess_kernel(x["means3d"])
    assert trast.uses_preprocess_kernel(x["means3d"].requires_grad_(True))


def test_preprocess_route_keeps_the_chain_on_cpu_tensors():
    x = _route_inputs(on_card=False)
    assert not trast.uses_preprocess_kernel(x["means3d"])
    with torch.no_grad():
        assert not trast.uses_preprocess_kernel(x["means3d"])


# K6's `needs` (means3d, scales, rotations, the camera) when one input
# alone asks a gradient; None where the Function hands the gradient on as a
# row of the cotangent, without K6
_K6_NEEDS = {"means3d": (True, False, False, False),
             "scales": (False, True, False, False),
             "rotations": (False, False, True, False),
             "opacities": None, "colors": None, "mean2d_offset": None,
             **{k: (False, False, False, True)
                for k in ("world_view_transform", "full_proj_transform",
                          "tan_fovx", "tan_fovy")}}


@pytest.mark.parametrize("name", [*_PROJECT_FLOATS, "tan_fovx", "tan_fovy"])
def test_preprocess_route_takes_the_kernel_where_a_gradient_is_asked(
        monkeypatch, name):
    """On the card a gradient asked of any one input (world_view_transform
    alone, as pose refinement asks) keeps project on the kernels, here
    replaced by their CPU stand-ins: K5 once, inside the projection's
    Function, and in the backward K6 once, asked for that input's gradient
    alone, or not at all where the gradient is a row of the cotangent
    (opacities, colours, mean2d_offset); the input receives it. Under
    no_grad K5 once, and no graph."""
    cfg = tpre.RasterConfig(tile=16, compact=256, kmax=4, chunk=64)
    x, cam = _cpu_inputs()
    x = {k: v.detach() for k, v in x.items()}
    tans = [t.detach().as_subclass(_OnCard) for t in cam[4:]]
    x.update(tan_fovx=tans[0], tan_fovy=tans[1])
    x[name].requires_grad_(True)
    calls, launches = [], []
    _stand_in_kernels(monkeypatch, calls, launches)

    def run():
        return trast.project(
            x["means3d"], x["scales"], x["rotations"], x["opacities"],
            x["colors"], x["world_view_transform"],
            x["full_proj_transform"], W, H, x["tan_fovx"], x["tan_fovy"],
            cfg, x["valid"], x["mean2d_offset"], 1.3)

    proj, feats, aux = run()
    assert len(launches) == 1 and feats.grad_fn is not None
    (grad,) = torch.autograd.grad(
        [feats.sum() + aux["depth"].sum() + proj.mean2d.sum()], [x[name]])
    assert calls == ([] if _K6_NEEDS[name] is None else [_K6_NEEDS[name]])
    assert grad.shape == x[name].shape and bool(grad.abs().sum() > 0)
    with torch.no_grad():
        _, feats, _ = run()
    assert len(launches) == 2 and feats.grad_fn is None
    assert len(calls) == (0 if _K6_NEEDS[name] is None else 1)


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
    render.preprocess_kernel), and a gradient through project none under
    render.preprocess_bwd_kernel; without a session nothing is counted."""
    kf, means, scales, quats, valid = _scene(seed=3)
    cfg = tpre.RasterConfig(tile=16, compact=256, kmax=4, chunk=64)
    args = [torch.as_tensor(a).requires_grad_(True)
            for a in (means, scales, quats)]
    cam = (torch.as_tensor(kf.world_view_transform),
           torch.as_tensor(kf.full_proj_transform), W, H,
           kf.camera.tan_fovx, kf.camera.tan_fovy)
    n = means.shape[0]
    op, col = torch.rand(n), torch.rand(n, 3)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _, feats, aux = trast.project(*args, op, col, *cam, cfg,
                                      torch.as_tensor(valid))
        (feats.sum() + aux["depth"].sum()).backward()
        visible_filter(*args, *cam, config=cfg, valid=torch.as_tensor(valid))
    counts = tracing.read()["counts"]
    tracing.reset()
    assert counts["render.preprocess_eager"] == 2
    assert "render.preprocess_kernel" not in counts
    assert "render.preprocess_bwd_kernel" not in counts
    assert all(torch.isfinite(a.grad).all() and a.grad.abs().sum() > 0
               for a in args)
    trast.project(*args, op, col, *cam, cfg, torch.as_tensor(valid))
    assert tracing.read()["counts"] == {}


def _chain(x, cam, cfg, offset, modifier=1.0):
    """The eager chain compute_cov3d + preprocess_gaussians + blend_inputs
    on x's tensors: (GaussianProjection, feats, aux)."""
    proj = tpre.preprocess_gaussians(
        x["means3d"], tpre.compute_cov3d(x["scales"], x["rotations"],
                                         modifier), *cam, cfg,
        valid_in=x["valid"])
    return (proj, *trast.blend_inputs(proj, x["opacities"], x["colors"],
                                      offset))


def _cpu_inputs(seed=3, tensor_fov=True):
    """_scene's gaussians as every input project differentiates, all
    requiring a gradient (tan_fov as 0-d tensors when tensor_fov)."""
    kf, means, scales, quats, valid = _scene(seed=seed, big=20)
    n = means.shape[0]
    rng = np.random.default_rng(seed + 1)
    x = {"means3d": means, "scales": scales, "rotations": quats,
         "opacities": rng.uniform(0, 1, (n, 1)),
         "colors": rng.uniform(0, 1, (n, 3)),
         "mean2d_offset": rng.normal(0, 0.5, (n, 2)),
         "world_view_transform": kf.world_view_transform,
         "full_proj_transform": kf.full_proj_transform}
    x = {k: torch.tensor(np.asarray(v, np.float32), requires_grad=True)
         for k, v in x.items()}
    x["valid"] = torch.as_tensor(valid)
    tans = (np.float32(kf.camera.tan_fovx), np.float32(kf.camera.tan_fovy))
    if tensor_fov:
        tans = tuple(torch.tensor(t, requires_grad=True) for t in tans)
    cam = (x["world_view_transform"], x["full_proj_transform"], W, H, *tans)
    return x, cam


_CPU_LEAVES = ("means3d", "scales", "rotations", "opacities", "colors",
               "mean2d_offset", "world_view_transform", "full_proj_transform")


@pytest.mark.parametrize("offset", [False, True])
def test_project_gradient_on_cpu_is_the_chains(offset):
    """On CPU tensors project is the eager chain, gradient and all: the
    gradient of every input (the camera's and the 0-d tan_fov tensors'
    among them) through project equals, bit for bit, the gradient through
    compute_cov3d + preprocess_gaussians + blend_inputs, with seeded
    cotangents on the blend rows, depth and mean2d."""
    cfg = tpre.RasterConfig(tile=16, compact=256, kmax=4, chunk=64)
    x, cam = _cpu_inputs()
    off = x["mean2d_offset"] if offset else None
    wrt = [x[k] for k in _CPU_LEAVES if offset or k != "mean2d_offset"]
    wrt += list(cam[4:])
    n = x["means3d"].shape[0]
    g = torch.Generator().manual_seed(5)
    cot = [torch.randn(9, n, generator=g), torch.randn(n, generator=g),
           torch.randn(n, 2, generator=g)]

    def grads(proj, feats, aux):
        return torch.autograd.grad([feats, aux["depth"], proj.mean2d], wrt,
                                   cot)

    got = grads(*trast.project(
        x["means3d"], x["scales"], x["rotations"], x["opacities"],
        x["colors"], *cam, cfg, x["valid"], off, 1.3))
    ref = grads(*_chain(x, cam, cfg, off, 1.3))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert all(bool(torch.isfinite(a).all()) for a in got)


@pytest.mark.parametrize("name", ["means3d", "scales", "rotations"])
def test_k6_rule_holds_rounding_and_refuses_a_planted_fault(name):
    """The rule that holds K6 to the chain (preprocess_ab.k6_holds), on the
    CPU: the chain's gradient computed in float64 and rounded to float32
    meets it against the float32 chain's, with cotangents on the alive
    slots (the blend backward's); the same gradient halved on the gaussians
    deeper than 1 (preprocess_ab.k6_fault) is refused, per gaussian."""
    kf, means, scales, quats, valid = _scene(n=4000, seed=5, big=200)
    cfg = tpre.RasterConfig(tile=16, compact=256, kmax=4, chunk=64)
    rng = np.random.default_rng(6)
    cot = torch.as_tensor(rng.normal(size=(4000, 10)))
    cot[rng.uniform(size=4000) < 0.5] = 0.0

    def grad(dtype):
        x = [torch.tensor(a, dtype=dtype, requires_grad=True)
             for a in (means, scales, quats)]
        cam = (torch.tensor(np.asarray(kf.world_view_transform), dtype=dtype),
               torch.tensor(np.asarray(kf.full_proj_transform), dtype=dtype),
               W, H, kf.camera.tan_fovx, kf.camera.tan_fovy)
        proj = tpre.preprocess_gaussians(
            x[0], tpre.compute_cov3d(x[1], x[2]), *cam, cfg,
            valid_in=torch.as_tensor(valid))
        feats, aux = trast.blend_inputs(proj, torch.ones(4000, dtype=dtype),
                                        torch.ones(4000, 3, dtype=dtype))
        c = torch.where(aux["alive"][:, None], cot, 0.0).to(dtype)
        g = torch.autograd.grad([feats, aux["depth"]], x,
                                [c[:, :9].T, c[:, 9]])
        return g[("means3d", "scales", "rotations").index(name)], aux

    ref, aux = grad(torch.float32)
    got, aux64 = grad(torch.float64)
    alive, depth = aux["alive"], aux["depth"].detach()
    assert torch.equal(alive, aux64["alive"]) and int(alive.sum()) > 1000
    gaps = preprocess_ab.k6_gaps(got.float(), ref, alive)
    assert preprocess_ab.k6_holds(gaps), gaps
    assert gaps["gaussian_gap"] < 1e-5 and gaps["over_share"] == 0.0
    fault = preprocess_ab.k6_gaps(
        preprocess_ab.k6_fault(got.float(), depth), ref, alive)
    assert not preprocess_ab.k6_holds(fault), fault
    # half the slots have no cotangent, and so no gradient to halve
    assert fault["gaussian_gap"] > 0.1 and fault["over_share"] > 0.25


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


def test_preprocess_backward_cuda_checks_its_inputs():
    """The K6 wrapper raises before any launch on a wrong shape or type of
    an input or a cotangent, and on tensors off the card; project raises
    on a host tan_fov tensor that asks a gradient (K6 reads tan_fov on the
    card), before K5's launch."""
    n = 6
    good = dict(means3d=torch.rand(n, 3), scales=torch.rand(n, 3),
                rotations=torch.rand(n, 4),
                world_view_transform=torch.eye(4),
                full_proj_transform=torch.eye(4), d_feats=torch.rand(9, n),
                d_depth=torch.rand(n))
    for name, bad in (("scales", torch.rand(n, 4)),
                      ("d_feats", torch.rand(10, n)),
                      ("d_depth", torch.rand(n, dtype=torch.float64)),
                      ("d_mean2d", torch.rand(n, 2))):
        args = dict(good, **{name: bad})
        with pytest.raises(ValueError, match=name):
            trast.preprocess_backward_cuda(**args, width=W, height=H,
                                           tan_fovx=0.5, tan_fovy=0.5)
    with pytest.raises(ValueError, match="CUDA"):
        trast.preprocess_backward_cuda(**good, width=W, height=H,
                                       tan_fovx=0.5, tan_fovy=0.5)
    x = _route_inputs()
    x["tan_fovx"] = torch.tensor(0.5, requires_grad=True)
    launches = trast.preprocess_cuda.launches
    with pytest.raises(ValueError, match="tan_fovx"):
        trast.project(x["means3d"], x["scales"], x["rotations"],
                      x["opacities"], x["colors"], x["world_view_transform"],
                      x["full_proj_transform"], W, H, x["tan_fovx"],
                      x["tan_fovy"], tpre.RasterConfig(), x["valid"])
    assert trast.preprocess_cuda.launches == launches


def _stand_in_kernels(monkeypatch, calls, launches=None):
    """The projection's Function on CPU tensors: the route forced to it,
    K5's launch replaced by the chain's values in K5's output layout and
    K6 by the chain's autograd gradient under K6's contract (the cotangents
    in, the gradients of means3d, scales, rotations, the camera and the
    0-d tan_fov tensors out, None where not asked), each K6 call's `needs`
    appended to `calls` and each K5 launch to `launches`."""
    def launch(means3d, scales, rotations, wvt, fpt, width, height, tx, ty,
               config, valid=None, opacities=None, colors=None,
               mean2d_offset=None, scale_modifier=1.0):
        if launches is not None:
            launches.append(1)
        x = {"means3d": means3d, "scales": scales, "rotations": rotations,
             "opacities": opacities, "colors": colors, "valid": valid}
        proj, feats, aux = _chain(x, (wvt, fpt, width, height, tx, ty),
                                  config, mean2d_offset, scale_modifier)
        ints = torch.stack([proj.radius, *proj.rect_min.T, *proj.rect_max.T,
                            proj.tiles_touched, aux["rect_w"]])
        mean2d = None if mean2d_offset is None else proj.mean2d.T
        rows = torch.cat([feats, proj.depth[None]])
        return (rows[:9], rows[9], mean2d, ints, aux["alive"],
                proj.kmax_truncated)

    def backward(means3d, scales, rotations, wvt, fpt, width, height, tx, ty,
                 d_feats, d_depth, d_mean2d=None, scale_modifier=1.0,
                 needs=(True,) * 4):
        calls.append(needs)
        tans = [t.detach().requires_grad_(True)
                if isinstance(t, torch.Tensor) else t for t in (tx, ty)]
        leaves = [t.detach().requires_grad_(True)
                  for t in (means3d, scales, rotations, wvt, fpt)]
        leaves += [t for t in tans if isinstance(t, torch.Tensor)]
        with torch.enable_grad():
            x = dict(zip(("means3d", "scales", "rotations"), leaves),
                     opacities=torch.zeros(len(means3d)),
                     colors=torch.zeros(len(means3d), 3), valid=None)
            cam = (leaves[3], leaves[4], width, height, *tans)
            proj, feats, aux = _chain(x, cam, tpre.RasterConfig(), None,
                                      scale_modifier)
            outs = [(feats, d_feats), (aux["depth"], d_depth),
                    (proj.mean2d.T, d_mean2d)]
            outs = [(o, c) for o, c in outs if c is not None]
            g = list(torch.autograd.grad(
                [o for o, _ in outs], leaves, [c for _, c in outs],
                allow_unused=True))
        d_tans = [g.pop(5) if isinstance(t, torch.Tensor) else None
                  for t in tans]
        asked = needs[:3] + (needs[3],) * 2
        return (*(gi if a else None for gi, a in zip(g, asked)),
                *(d if needs[3] else None for d in d_tans))

    monkeypatch.setattr(trast, "uses_preprocess_kernel", lambda means3d: True)
    monkeypatch.setattr(trast, "_launch_preprocess", launch)
    monkeypatch.setattr(trast, "preprocess_backward_cuda", backward)


@pytest.mark.parametrize("offset,camera", [(False, False), (True, False),
                                           (True, True)])
def test_projection_function_routes_each_gradient(monkeypatch, offset,
                                                  camera):
    """The projection's Function, its kernels replaced by CPU stand-ins
    that keep their contracts: every input's gradient through project
    (opacities [N, 1], colours and mean2d_offset as views of the blend
    rows' cotangent, means3d, scales, rotations and, when they ask one, the
    camera matrices from the backward) equals the chain's within 1e-6 of
    its largest; the backward is asked for the camera only when a matrix
    requires a gradient, and counted once under render.preprocess_bwd_kernel
    in a profiler session."""
    cfg = tpre.RasterConfig(tile=16, compact=256, kmax=4, chunk=64)
    x, cam = _cpu_inputs(tensor_fov=False)
    for k in ("world_view_transform", "full_proj_transform"):
        x[k].requires_grad_(camera)
    off = x["mean2d_offset"] if offset else None
    wrt = [x[k] for k in _CPU_LEAVES if (offset or k != "mean2d_offset")
           and (camera or not k.endswith("_transform"))]
    n = x["means3d"].shape[0]
    g = torch.Generator().manual_seed(7)
    cot = [torch.randn(n, 10, generator=g), torch.randn(n, 2, generator=g)]

    def grads(proj, feats, aux):
        outs = [feats, aux["depth"], proj.mean2d]
        return torch.autograd.grad(outs, wrt, [cot[0][:, :9].T, cot[0][:, 9],
                                               cot[1]])

    ref = grads(*_chain(x, cam, cfg, off, 1.3))
    calls = []
    _stand_in_kernels(monkeypatch, calls)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = grads(*trast.project(
            x["means3d"], x["scales"], x["rotations"], x["opacities"],
            x["colors"], *cam, cfg, x["valid"], off, 1.3))
    counts = tracing.read()["counts"]
    tracing.reset()
    assert counts["render.preprocess_bwd_kernel"] == 1
    assert counts["render.preprocess_kernel"] == 1
    assert calls == [(True, True, True, camera)]
    for a, b, leaf in zip(got, ref, wrt):
        assert a.shape == leaf.shape
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= 1e-6 * scale


def test_projection_function_refuses_a_second_derivative(monkeypatch):
    """K6 computes the gradient outside autograd, so the projection's
    Function is once differentiable: a derivative of its gradient raises
    instead of treating K6's outputs as constants."""
    cfg = tpre.RasterConfig(tile=16, compact=256, kmax=4, chunk=64)
    x, cam = _cpu_inputs(tensor_fov=False)
    _stand_in_kernels(monkeypatch, [])
    _, feats, aux = trast.project(
        x["means3d"], x["scales"], x["rotations"], x["opacities"],
        x["colors"], *cam, cfg, x["valid"])
    (grad,) = torch.autograd.grad(feats[2:5].square().sum()
                                  + aux["depth"].sum(), [x["means3d"]],
                                  create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        grad.square().sum().backward()


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


# On the card: K6 against the chain's autograd gradient.

def _edge_rows(n):
    """Rows of _card_inputs that hold an edge case (see there)."""
    idx = np.arange(n)
    rows = np.zeros(n, bool)
    for mod, hit in ((53, 11), (97, 0), (101, 1), (13, 2), (89, 3), (7, 4)):
        rows |= idx % mod == hit
    return rows | ((idx % 211 >= 5) & (idx % 211 <= 10))


def _check_backward(x, cam, rc, offset, modifier, camera, alive_only,
                    seed=0, held=None):
    """Gradients of every differentiable input through project (K5 + K6)
    against the chain's (`preprocess_ab.k6_compare`; with `held` [N], the
    values of the held slots' rows and the finiteness of every slot's),
    with seeded cotangents in the blend backward's [N, 10] layout, zero on
    about half the slots and, with `alive_only`, on every slot not alive
    (the blend backward's), and with an offset on mean2d. Holds K6 to one
    call."""
    n = x["means3d"].shape[0]
    dev = x["means3d"].device
    names = ["means3d", "scales", "rotations", "opacities", "colors"]
    if offset:
        names.append("mean2d_offset")
    leaves = {k: x[k].detach().clone().requires_grad_(True) for k in names}
    if camera:
        for k in ("world_view_transform", "full_proj_transform"):
            leaves[k] = x[k].detach().clone().requires_grad_(True)
    tans = [t.detach().clone().requires_grad_(camera)
            if isinstance(t, torch.Tensor) else t for t in cam[4:]]
    cam = (leaves.get("world_view_transform", cam[0]),
           leaves.get("full_proj_transform", cam[1]), cam[2], cam[3], *tans)
    wrt = list(leaves.values()) + [t for t in tans
                                   if isinstance(t, torch.Tensor) and camera]
    xs = dict(x, **leaves)
    off = leaves.get("mean2d_offset")
    outs = trast.project(
        xs["means3d"], xs["scales"], xs["rotations"], xs["opacities"],
        xs["colors"], *cam, rc, x["valid"], off, modifier)
    alive, depth = outs[2]["alive"], outs[2]["depth"].detach()
    g = torch.Generator(device=dev).manual_seed(seed)
    dorig = torch.randn(n, 10, generator=g, device=dev)
    dorig[torch.rand(n, generator=g, device=dev) < 0.5] = 0.0
    if alive_only:
        dorig[~alive] = 0.0
    d_mean2d = torch.randn(n, 2, generator=g, device=dev)

    def grads(proj, feats, aux):
        outs = [feats, aux["depth"]] + ([proj.mean2d] if offset else [])
        cots = [dorig[:, :9].T, dorig[:, 9]] + ([d_mean2d] if offset else [])
        return torch.autograd.grad(outs, wrt, cots)

    calls = trast.preprocess_backward_cuda.launches
    got = grads(*outs)
    torch.cuda.synchronize()
    assert trast.preprocess_backward_cuda.launches == calls + 1
    ref = grads(*_chain(xs, cam, rc, off, modifier))
    names = list(leaves) + ["tan_fovx", "tan_fovy"]
    if held is None:
        return preprocess_ab.k6_compare(names, got, ref, alive, depth)

    def rows(grads):
        return [t[held] if t.dim() and t.shape[0] == n else t for t in grads]

    gaps = preprocess_ab.k6_compare(names, rows(got), rows(ref),
                                    alive[held], depth[held])
    for name, a, b in zip(names, got, ref):  # finiteness on every slot
        gaps[name]["mismatched"] = preprocess_ab.k6_gaps(a, b)["mismatched"]
        gaps[name]["holds"] = preprocess_ab.k6_holds(gaps[name])
    return gaps


def _report(tag, gaps):
    print(f"\n[K6] {tag}: " + ", ".join(
        f"{k} {g['gap']:.2e}"
        + (f" / a gaussian {g['gaussian_gap']:.2e}, "
           f"{g['over_share']:.1e} over 2e-4"
           if "gaussian_gap" in g else "")
        + f" ({g['mismatched']} mismatched, {g['nonfinite']} non-finite)"
        for k, g in gaps.items()))


def _assert_holds(gaps):
    """Every input's gradient meets preprocess_ab.k6_holds, and the rule
    refuses each per-gaussian gradient with the planted fault."""
    for name, g in gaps.items():
        assert g["holds"], (name, g)
        assert g.get("fault_refused", True), (name, g)


@pytest.mark.cuda
@pytest.mark.parametrize("camera", [False, True])
@pytest.mark.parametrize("fov", ["device", "host"])
@pytest.mark.parametrize("binning", ["bounded", "exact"])
@pytest.mark.parametrize("size", [(640, 480), (1200, 680), (1297, 840)])
def test_preprocess_backward_kernel_matches_the_chain(
        cuda_device, size, binning, fov, camera):
    """K6 (with K5 forward, one call of each) against the eager chain's
    autograd gradient on the card, for every input the chain
    differentiates, on _card_inputs' 2^20 gaussians at the two room sizes
    and the garden's: on the bounded route (the kmax clamp engaged) and
    the exact one; tan_fov as 0-d device tensors (no offset) and as host
    values (with mean2d_offset, a mean2d cotangent and a scale modifier);
    with the camera matrices and device tan_fov asking a gradient, and
    without; with cotangents on every slot and on the alive slots alone
    (the blend backward's). Each input's gradient within 2e-4 of its
    largest (the JAX suite's rule) and each alive gaussian's within 2e-4 of
    its own bar a 1e-3 share, within 1e-2 all (preprocess_ab.k6_holds);
    non-finite exactly where the chain's are (the NaN / inf inputs and what
    they reach); the rule refuses the gradient halved beyond depth 1. The
    camera's gradient sums every gaussian, so with it asked the edge-case
    rows are left out (a NaN anywhere makes the chain's sum NaN)."""
    width, height = size
    kf, x = _card_inputs(width, height, cuda_device)
    rc = (_TRAIN_RC if binning == "bounded"
          else tpre.RasterConfig(compact=0, kmax=0))
    if camera:
        keep = torch.as_tensor(~_edge_rows(x["means3d"].shape[0]),
                               device=cuda_device)
        x = {k: v[keep] if v.dim() and k != "world_view_transform"
             and k != "full_proj_transform" else v for k, v in x.items()}
    tans = (np.float32(kf.camera.tan_fovx), np.float32(kf.camera.tan_fovy))
    offset, mod = (True, 1.3) if fov == "host" else (False, 1.0)
    if fov == "device":
        tans = tuple(torch.tensor(t, device=cuda_device) for t in tans)
    cam = (x["world_view_transform"], x["full_proj_transform"], width,
           height, *tans)
    for alive_only in (False, True):
        gaps = _check_backward(x, cam, rc, offset, mod, camera, alive_only)
        _report(f"{size} {binning} {fov} camera={camera} "
                f"alive_only={alive_only}", gaps)
        _assert_holds(gaps)
        want = ({"world_view_transform", "full_proj_transform"} if camera
                else set())
        if camera and fov == "device":
            want |= {"tan_fovx", "tan_fovy"}
        assert want <= set(gaps)
        if not camera:  # the NaN / inf inputs reach the gradient
            assert gaps["means3d"]["nonfinite"] > 0
            assert gaps["rotations"]["nonfinite"] > 0


def _edge_inputs(dev, tan_on_device: bool, n_each=20_000, seed=0):
    """Gaussians before an identity-pose camera at 640x480 (so that view
    coordinates are the means' exact values), by group: x and y exactly at
    +-1.3 tan_fov times depth (ties of the clamp's maximum and minimum),
    rank-1 covariances of scales (s, 0, 0) with s up to 1e8 (det == 0),
    depths within 1e-3 of the near plane and exactly at it, at the camera
    centre, behind the camera, NaN and inf in the means, and regular ones;
    valid_in false on a sixth."""
    rng = np.random.default_rng(seed)
    w, h = 640, 480
    cam = TCamera(camera_id=0, width=w, height=h, fx=0.8 * w, fy=0.8 * w,
                  cx=w / 2, cy=h / 2)
    kf = TKeyframe(kf_id=0, camera=cam, quat=[1, 0, 0, 0], trans=[0, 0, 0])
    tans = [np.float32(cam.tan_fovx), np.float32(cam.tan_fovy)]
    if tan_on_device:
        tans = [torch.tensor(t, device=dev) for t in tans]
    # the clamp limits as compute_cov2d rounds them
    lim = [float(torch.as_tensor(1.3 * t, dtype=torch.float32, device=dev))
           for t in tans]
    m = n_each
    z = rng.uniform(0.5, 8.0, 9 * m)
    means = np.stack([rng.uniform(-1, 1, 9 * m) * lim[0] * z,
                      rng.uniform(-1, 1, 9 * m) * lim[1] * z, z], -1)
    scales = np.exp(rng.uniform(-5.0, -1.0, (9 * m, 3)))
    groups = [slice(k * m, (k + 1) * m) for k in range(9)]
    # ties: z = 2 and the coordinate at +-2 lim, exact in f32
    for axis, grp in ((0, groups[0]), (1, groups[1])):
        means[grp, 2] = 2.0
        means[grp, axis] = np.where(rng.uniform(size=m) < 0.5, 2.0, -2.0) \
            * np.float32(lim[axis])
    scales[groups[2]] = 0.0
    scales[groups[2], 0] = 10.0 ** rng.uniform(1.5, 8.0, m)
    means[groups[3], 2] = 0.2 + rng.uniform(-1e-3, 1e-3, m)
    means[groups[3].start:groups[3].start + 100, 2] = 0.2
    means[groups[4]] = 0.0
    means[groups[5], 2] = -means[groups[5], 2]
    means[groups[6].start::2][:m // 2, 0] = np.nan
    means[groups[6].start + 1::2][:m // 2, 1] = np.inf
    quats = rng.normal(size=(9 * m, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    x = {"means3d": f32(means), "scales": f32(scales), "rotations": f32(quats),
         "opacities": f32(rng.uniform(0, 1, 9 * m)),
         "colors": f32(rng.uniform(0, 1, (9 * m, 3))),
         "valid": torch.as_tensor(rng.uniform(size=9 * m) > 1 / 6,
                                  device=dev),
         "mean2d_offset": f32(rng.normal(0, 0.5, (9 * m, 2))),
         "world_view_transform": f32(kf.world_view_transform),
         "full_proj_transform": f32(kf.full_proj_transform)}
    return x, (x["world_view_transform"], x["full_proj_transform"], w, h,
               *tans), groups


@pytest.mark.cuda
@pytest.mark.parametrize("fov", ["device", "host"])
def test_preprocess_backward_kernel_edge_cases(cuda_device, fov):
    """K6 against the chain's gradient on _edge_inputs: ties of the tan_fov
    clamp (half the cotangent to each side), det == 0, the near plane, the
    camera centre, behind the camera, culled and masked slots, NaN and inf
    means; cotangents on every slot and on the alive slots alone; the
    gradients held by preprocess_ab.k6_holds (as in the test above; the
    rank-1 group by finiteness alone), non-finite exactly where the
    chain's are. The cases are exercised: ties, det == 0 and non-finite
    gradients occur."""
    x, cam, groups = _edge_inputs(cuda_device, fov == "device")
    w, h, tx, ty = cam[2:]
    with torch.no_grad():
        cov2 = tpre.compute_cov2d(
            x["means3d"], tpre.compute_cov3d(x["scales"], x["rotations"]),
            cam[0], w / (2.0 * tx), h / (2.0 * ty), tx, ty)
        det = cov2[:, 0] * cov2[:, 2] - cov2[:, 1] * cov2[:, 1]
        lim = float(torch.as_tensor(1.3 * tx, dtype=torch.float32,
                                    device=cuda_device))
        qx = x["means3d"][groups[0], 0] / x["means3d"][groups[0], 2]
    assert int((det[groups[2]] == 0).sum()) > 100
    assert int((qx.abs() == lim).sum()) == qx.numel()
    # the rank-1 group's covariances (scales to 1e8) cancel below f32's
    # resolution in det: there the chain's own f32 gradient is off the
    # float64 chain's by a median 2e-3 of a gaussian's largest (means) and
    # by all of it (rotations), and K6's by as much, so that group is held
    # by finiteness alone
    held = torch.ones(x["means3d"].shape[0], dtype=torch.bool,
                      device=cuda_device)
    held[groups[2]] = False
    for alive_only in (False, True):
        gaps = _check_backward(x, cam, _TRAIN_RC, fov == "host",
                               1.3 if fov == "host" else 1.0, False,
                               alive_only, held=held)
        _report(f"edge {fov} alive_only={alive_only}", gaps)
        _assert_holds(gaps)
        assert gaps["means3d"]["nonfinite"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("binning", ["bounded", "exact"])
def test_train_step_with_the_kernels_equals_the_chain(cuda_device, binning):
    """One train step of a seeded full-width map (2^16 anchor slots x 10
    offsets, 2^15 active) at 640x480, pose refinement on the keyframe's row
    (the camera's gradient asked), through K5 + K6 and again with the
    eager chain forced: the loss bit for bit (K5's values are the chain's),
    every leaf's gradient within 2e-4 of its largest, the non-finite count
    equal; K5 twice a step (prefilter and projection), K6 once."""
    from segs_slam_tpu_torch.io.convert import (
        anchors_from_numpy,
        decoders_from_jax,
        flatten_params,
    )
    from segs_slam_tpu_torch.models.config import ModelConfig
    from segs_slam_tpu_torch.train.config import OptimizationConfig
    from segs_slam_tpu_torch.train.optimizer import leaves
    from segs_slam_tpu_torch.train.step import (
        init_train_state,
        make_train_step,
    )
    from segs_slam_tpu_torch.utils.synthetic import seeded_map

    mc = ModelConfig()
    anchors_np, dec_np = seeded_map(mc, n_active=2**15, seed=0)
    rc = (tpre.RasterConfig(tile=16, compact=2**16, kmax=8, chunk=256,
                            ksmall=4, nlarge=2**13)
          if binning == "bounded" else tpre.RasterConfig(compact=0, kmax=0))
    oc = OptimizationConfig(start_stat=0,
                            high_frequency_regularization_start=0)
    w, h = 640, 480
    camera = TCamera(camera_id=0, width=w, height=h, fx=500.0, fy=500.0,
                     cx=w / 2, cy=h / 2)
    kf = TKeyframe(kf_id=0, camera=camera, quat=[1, 0, 0, 0],
                   trans=[0, 0, 0])
    cam = {k: torch.as_tensor(v, device=cuda_device)
           for k, v in kf.render_inputs().items()}
    gt = torch.as_tensor(np.random.default_rng(3).uniform(
        0, 1, (3, h, w)).astype(np.float32), device=cuda_device)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda_device)
    results = []
    for route in ("kernels", "chain"):
        ts = init_train_state(
            anchors_from_numpy(anchors_np, cuda_device),
            decoders_from_jax(flatten_params(dec_np), cuda_device), mc,
            max_pose_kfs=2)
        step = make_train_step(mc, oc, rc, w, h)
        k5 = trast.preprocess_cuda.launches
        k6 = trast.preprocess_backward_cuda.launches
        forced = preprocess_ab.chain_forced() if route == "chain" else \
            contextlib.nullcontext()
        with forced:
            ts, m = step(ts, cam, gt, bg, kf_row=1)
        torch.cuda.synchronize()
        launches = (trast.preprocess_cuda.launches - k5,
                    trast.preprocess_backward_cuda.launches - k6)
        # the first step's moments are (1 - b1) g: the sanitised gradients
        results.append((float(m["loss"]), int(m["nonfinite_grads"]),
                        launches, {p: x / 0.1 for p, x in leaves(ts.adam.mu)
                                   if x.numel()}))
    (loss, nonfinite, launches, grads), (loss_c, nonfinite_c, launches_c,
                                         grads_c) = results
    gaps = {".".join(p): preprocess_ab.k6_gaps(grads[p], g)["gap"]
            for p, g in grads_c.items()}
    worst = max(gaps.items(), key=lambda kv: kv[1])
    print(f"\n[K6 step] {binning}: loss {loss!r} / {loss_c!r}, non-finite "
          f"{nonfinite} / {nonfinite_c}, launches (K5, K6) {launches} / "
          f"{launches_c}, worst leaf gap {worst}, pose gap {gaps['pose']:.2e}")
    assert loss == loss_c
    assert nonfinite == nonfinite_c
    assert launches == (2, 1) and launches_c == (0, 0)
    assert worst[1] <= 2e-4
    assert float(grads_c[("pose",)].abs().max()) > 0
