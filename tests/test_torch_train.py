"""The port's training modules against the JAX package's on the CPU, at the
sizes of tests/test_train_step.py (32x32, capacity 64, feat_dim 8,
n_offsets 4): schedules, losses and their gradients, one Adam update, render
gradients, and the first steps of make_train_step from one shared state.

Tolerances, and why they are not tighter:
  * losses and schedules: f32 rounding of the same formulas (rtol 1e-5);
  * gradients: 2e-4 after scaling each leaf by its largest magnitude (the
    convention of tests/test_rasterizer.py:137-139): the blend backward sums
    in another order than JAX's kernel, and scatter-adds in no fixed order;
  * the Adam update given identical inputs: f32 rounding (rtol 1e-6);
  * a step's gradients are read back from the Adam first moments,
    g = (mu' - b1 mu) / (1 - b1), which costs a digit.
Parameters are not compared after many steps: Adam's eps of 1e-15 turns a
gradient of 1e-20 in one implementation and 0 in the other into a full-lr
step in one and none in the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segs_slam_tpu.core import Camera
from segs_slam_tpu.core.keyframe import Keyframe
from segs_slam_tpu.models.anchors import empty_state as j_empty_state
from segs_slam_tpu.models.anchors import insert_points as j_insert_points
from segs_slam_tpu.models.config import ModelConfig as JModelConfig
from segs_slam_tpu.models.decoders import init_decoders
from segs_slam_tpu.models.renderer import render as j_render
from segs_slam_tpu.ops.rasterizer import RasterConfig as JRasterConfig
from segs_slam_tpu.train import losses as jlosses
from segs_slam_tpu.train import optimizer as joptimizer
from segs_slam_tpu.train.config import OptimizationConfig as JOptConfig
from segs_slam_tpu.train.step import init_train_state as j_init_train_state
from segs_slam_tpu.train.step import make_train_step as j_make_train_step
from segs_slam_tpu_torch.io.convert import (
    train_state_from_jax,
    train_state_to_numpy,
)
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.models.renderer import render
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from segs_slam_tpu_torch.train import losses, optimizer
from segs_slam_tpu_torch.train.config import OptimizationConfig
from segs_slam_tpu_torch.train.step import make_train_step
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

W, H = 32, 32
SMALL = dict(feat_dim=8, n_offsets=4, appearance_dim=8, embedding_dim=4,
             capacity=64, voxel_size=0.05)
OPT = dict(start_stat=2, update_from=4, update_interval=5, update_until=100,
           use_frequency_regularization=False)
RASTER = dict(tile=16, compact=512, kmax=32, chunk=64)


def _scaled_close(ours, ref, name, tol=2e-4):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, name
    assert np.isfinite(ours).all(), name
    scale = np.abs(ref).max() + 1e-12
    np.testing.assert_allclose(ours / scale, ref / scale, atol=tol, rtol=0,
                               err_msg=name)


def _tree(x):
    """NamedTuples and dicts as nested dicts of numpy arrays."""
    if hasattr(x, "_asdict"):
        x = x._asdict()
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return np.asarray(x)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.fixture(scope="module")
def setup():
    """The JAX initial train state, a gt image and the camera (as in
    tests/test_train_step.py)."""
    jmc = JModelConfig(**SMALL)
    cam = Camera(camera_id=0, width=W, height=H, fx=30.0, fy=30.0, cx=16,
                 cy=16)
    kf = Keyframe(kf_id=0, camera=cam, quat=[0.999, 0.02, -0.03, 0.01],
                  trans=[0.05, 0, 0])
    rng = np.random.default_rng(0)
    pts = rng.uniform([-0.8, -0.6, 1.5], [0.8, 0.6, 4.0], size=(40, 3))
    anchors, _ = j_insert_points(j_empty_state(jmc), pts, jmc)
    jts = j_init_train_state(anchors, init_decoders(jax.random.PRNGKey(0),
                                                    jmc), jmc)
    gt = rng.uniform(0.1, 0.9, size=(3, H, W)).astype(np.float32)
    gt[:, :4, :6] = 0.0  # a black patch: the gt mask
    gt_depth = rng.uniform(1.5, 3.5, size=(H, W)).astype(np.float32)
    gt_depth[-3:] = 0.0
    return jts, gt, gt_depth, kf.render_inputs()


def test_lr_schedules_match_jax():
    for spatial in (1.0, 2.7):
        ours = OptimizationConfig(spatial_lr_scale=spatial).lr_schedules()
        ref = JOptConfig(spatial_lr_scale=spatial).lr_schedules()
        assert ours.keys() == ref.keys()
        for name in ours:
            for step in (0, 1, 7, 100, 12_345, 29_999, 30_000, 40_000):
                np.testing.assert_allclose(
                    ours[name](step), float(ref[name](step)), rtol=1e-6,
                    atol=0, err_msg=f"{name} @ {step}")
    delayed = dict(lr_init=0.01, lr_final=1e-4, lr_delay_steps=50,
                   lr_delay_mult=0.1, max_steps=1000)
    from segs_slam_tpu.train.schedules import ExponLR as JExponLR
    from segs_slam_tpu_torch.train.schedules import ExponLR
    for step in (0, 10, 49, 50, 999, 1000, 5000):
        np.testing.assert_allclose(ExponLR(**delayed)(step),
                                   float(JExponLR(**delayed)(step)),
                                   rtol=1e-6, err_msg=str(step))


LOSSES = {
    "l1": (losses.l1_loss, jlosses.l1_loss),
    "psnr": (losses.psnr, jlosses.psnr),
    "psnr_gs": (losses.psnr_gaussian_splatting,
                jlosses.psnr_gaussian_splatting),
    "ssim": (losses.ssim, jlosses.ssim),
    "high_freq": (losses.high_frequency_loss, jlosses.high_frequency_loss),
    "high_freq_ideal": (
        lambda a, b: losses.high_frequency_loss(a, b, freq_mode="ideal"),
        lambda a, b: jlosses.high_frequency_loss(a, b, freq_mode="ideal")),
    "low_freq": (losses.low_freq_loss, jlosses.low_freq_loss),
    "low_freq_ideal": (
        lambda a, b: losses.low_freq_loss(a, b, freq_mode="ideal"),
        lambda a, b: jlosses.low_freq_loss(a, b, freq_mode="ideal")),
    "multi_scale": (losses.multi_scale_loss, jlosses.multi_scale_loss),
    "multi_scale_ideal": (
        lambda a, b: losses.multi_scale_loss(a, b, freq_mode="ideal"),
        lambda a, b: jlosses.multi_scale_loss(a, b, freq_mode="ideal")),
}


@pytest.mark.parametrize("name", list(LOSSES))
def test_losses_and_gradients_match_jax(name):
    ours_fn, ref_fn = LOSSES[name]
    rng = np.random.default_rng(list(LOSSES).index(name))
    pred = rng.uniform(0, 1, (3, 32, 48)).astype(np.float32)
    gt = rng.uniform(0, 1, (3, 32, 48)).astype(np.float32)
    pred[:, :5, :7] = gt[:, :5, :7] = 0.0  # masked pixels: zero bins
    ref_v, ref_g = jax.value_and_grad(ref_fn)(jnp.asarray(pred),
                                              jnp.asarray(gt))
    p = torch.tensor(pred, requires_grad=True)
    v = ours_fn(p, torch.tensor(gt))
    np.testing.assert_allclose(float(v.detach()), float(ref_v), rtol=1e-5,
                               atol=1e-7)
    if v.requires_grad:
        (g,) = torch.autograd.grad(v, p)
        g, ref_g = g.numpy(), np.asarray(ref_g)
        if name == "l1":
            # at pred == gt JAX's |x| passes +1 and torch's 0; in the train
            # step such ties are masked pixels, whose gradient the gt mask
            # zeroes in both
            tie = pred == gt
            g, ref_g = g[~tie], ref_g[~tie]
        _scaled_close(g, ref_g, name)
    else:  # the reference-mode low-pass loss is identically zero
        assert float(v) == 0.0 and not np.asarray(ref_g).any()


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.25])
def test_bilinear_resize_matches_jax_image_resize(scale):
    img = np.random.default_rng(1).uniform(0, 1, (3, 32, 48)).astype(
        np.float32)
    ours = losses._bilinear_resize(torch.tensor(img), scale).numpy()
    ref = np.asarray(jlosses._bilinear_resize(jnp.asarray(img), scale))
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    if scale < 1.0:  # jax.image.resize anti-aliases; plain bilinear does not
        plain = torch.nn.functional.interpolate(
            torch.tensor(img)[None], size=ref.shape[1:], mode="bilinear",
            align_corners=False)[0].numpy()
        assert np.abs(plain - ref).max() > 0.1


def test_adam_update_matches_jax():
    rng = np.random.default_rng(2)
    shapes = {"anchors": {"feat": (6, 3), "offset": (6, 2, 3)},
              "decoders": {"w": (4, 5)}}
    mk = lambda s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    params = {g: {k: mk(s) for k, s in d.items()} for g, d in shapes.items()}
    grads = {g: {k: mk(s) for k, s in d.items()} for g, d in shapes.items()}
    mu = {g: {k: 0.1 * mk(s) for k, s in d.items()}
          for g, d in shapes.items()}
    nu = {g: {k: np.abs(0.01 * mk(s)) for k, s in d.items()}
          for g, d in shapes.items()}
    grads["anchors"]["feat"][1] = 0.0  # a zero gradient row: no update
    mask = np.array([True, True, False, True, False, True])
    lrs = {"feat": 0.001, "offset": 0.07, "w": 0.004}
    mode = {"feat": "adam", "offset": "sgd", "w": "amsmax"}

    jtree = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    ref_p, ref_s = joptimizer.update(
        jtree(params), jtree(grads),
        joptimizer.AdamState(jnp.int32(4), jtree(mu), jtree(nu)),
        jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.float32(lrs[path[-1].key]), params),
        row_mask_fn=lambda p: jnp.asarray(mask)
        if p[0].key == "anchors" else None,
        mode_fn=lambda p: mode[p[-1].key])

    ttree = lambda t: {g: {k: torch.tensor(v) for k, v in d.items()}  # noqa
                       for g, d in t.items()}
    ours_p = ttree(params)
    state = optimizer.AdamState(4, ttree(mu), ttree(nu))
    optimizer.update(ours_p, ttree(grads), state, lambda p: lrs[p[-1]],
                     row_mask_fn=lambda p: torch.tensor(mask)
                     if p[0] == "anchors" else None,
                     mode_fn=lambda p: mode[p[-1]])
    assert state.step == 5
    for ours, ref in ((ours_p, ref_p), (state.mu, ref_s.mu),
                      (state.nu, ref_s.nu)):
        for g in shapes:
            for k in shapes[g]:
                np.testing.assert_allclose(ours[g][k].numpy(),
                                           np.asarray(ref[g][k]), rtol=1e-6,
                                           atol=1e-9, err_msg=f"{g}.{k}")
    np.testing.assert_array_equal(ours_p["anchors"]["feat"][~mask],
                                  params["anchors"]["feat"][~mask])

    optimizer.reset_rows(state, lambda p: p[0] == "anchors",
                         torch.tensor(mask))
    assert not state.mu["anchors"]["offset"][mask].any()
    perm = torch.tensor([5, 4, 3, 2, 1, 0])
    before = state.nu["anchors"]["feat"].clone()
    optimizer.permute_rows(state, lambda p: p[0] == "anchors", perm)
    assert torch.equal(state.nu["anchors"]["feat"], before[perm])


def test_render_gradients_match_jax(setup):
    """Gradients of an image + depth + final_T loss through the whole
    render (decoders, neural gaussians, rasterize) for every trainable
    leaf."""
    jts, gt, _, cam_np = setup
    jmc, jrc = JModelConfig(**SMALL), JRasterConfig(**RASTER)
    bg = np.array([0.1, 0.3, 0.2], np.float32)
    cam_j = {k: jnp.asarray(v) for k, v in cam_np.items()}

    def combined(out, lib):
        return (((out.image - lib.asarray(gt)) ** 2).sum()
                + 0.1 * out.depth_map.sum() + (out.final_T ** 2).sum())

    def j_loss(params):
        out = j_render(jts.anchors.replace_params(params["anchors"]),
                       params["decoders"], cam_j, W, H, jnp.asarray(bg), jmc,
                       jrc, interpret=True)
        return combined(out, jnp)

    params = {"anchors": jts.anchors.params(), "decoders": jts.decoders}
    ref = _flat(_tree(jax.grad(j_loss)(params)))

    ts = train_state_from_jax(_tree(jts))
    leaves = {n: t.detach().requires_grad_()
              for n, t in ts.anchors.params().items()}
    dec = dict(ts.decoders.named_parameters())
    out = render(ts.anchors.replace_params(leaves), ts.decoders,
                 {k: torch.as_tensor(v) for k, v in cam_np.items()}, W, H,
                 torch.tensor(bg), ModelConfig(**SMALL),
                 RasterConfig(**RASTER))
    grads = torch.autograd.grad(combined(out, torch),
                                [*leaves.values(), *dec.values()],
                                allow_unused=True)
    names = [f"anchors.{n}" for n in leaves] + list(dec)
    for name, x, g in zip(names, [*leaves.values(), *dec.values()], grads):
        g = torch.zeros_like(x) if g is None else g
        path, _, leaf = name.rpartition(".")
        if leaf == "weight":  # nn.Linear (out, in) against JAX (in, out)
            name, g = f"decoders.{path}.w", g.T
        elif leaf == "bias":
            name = f"decoders.{path}.b"
        elif not name.startswith("anchors."):
            name = f"decoders.{name}"
        _scaled_close(g.numpy(), ref[name], name)
    assert np.abs(ref["anchors.feat"]).max() > 0


def _step_grads(mu_new, mu_old, b1=0.9):
    """A step's (sanitised) gradient, recovered from the Adam first
    moments."""
    return (mu_new - b1 * mu_old) / (1 - b1)


@pytest.mark.parametrize("variant", ["plain", "depth_freq"])
def test_first_train_steps_match_jax(setup, variant):
    """Five steps: each from the JAX state of the step before, so that the
    losses, the step's gradients (read from the moments, active rows) and
    the densify statistics are compared on identical inputs; then the
    port's own five-step loss trajectory against JAX's."""
    jts, gt, gt_depth, cam_np = setup
    opt = dict(OPT)
    grad_tol = 2e-4
    if variant == "depth_freq":
        opt.update(lambda_depth=0.5, use_frequency_regularization=True,
                   high_frequency_regularization_start=1)
        # here JAX's jitted step strays from the same step run eagerly (XLA
        # compiles the fused loss differently): on one anchor the port differs
        # from it by more than 2e-4, while it stays within 2e-4 of the
        # eager step (test_torch_trainer.py::
        # test_train_step_matches_eager_jax_step)
        grad_tol = 2e-3
    jmc, joc, jrc = (JModelConfig(**SMALL), JOptConfig(**opt),
                     JRasterConfig(**RASTER))
    mc, oc, rc = (ModelConfig(**SMALL), OptimizationConfig(**opt),
                  RasterConfig(**RASTER))
    j_step = jax.jit(j_make_train_step(jmc, joc, jrc, W, H, interpret=True))
    t_step = make_train_step(mc, oc, rc, W, H)
    cam_j = {k: jnp.asarray(v) for k, v in cam_np.items()}
    cam_t = {k: torch.as_tensor(v) for k, v in cam_np.items()}
    bg = np.zeros(3, np.float32)
    depth_kw = variant == "depth_freq"
    j_args = (cam_j, jnp.asarray(gt), jnp.asarray(bg), None,
              jnp.asarray(gt_depth) if depth_kw else None)
    t_kw = dict(gt_depth=torch.tensor(gt_depth) if depth_kw else None)

    state = _tree(jts)
    ours_traj = train_state_from_jax(state)
    j_losses, t_losses = [], []
    for i in range(5):
        j_new, jm = j_step(jts, *j_args)
        ts = train_state_from_jax(state)
        ts, tm = t_step(ts, cam_t, torch.tensor(gt), torch.tensor(bg),
                        **t_kw)
        new = _tree(j_new)
        ours = train_state_to_numpy(ts)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
        for key in ("num_instances", "num_compact", "n_active",
                    "nonfinite_grads"):
            assert int(tm[key]) == int(jm[key]), (i, key)
        active = state["anchors"]["active"]
        g_ref = _flat(_tree(new["adam"]["mu"]))
        g_old = _flat(_tree(state["adam"]["mu"]))
        g_ours = _flat(ours["adam"]["mu"])
        for name in g_ref:
            if name.startswith("pose"):
                continue
            ref = _step_grads(g_ref[name], g_old[name])
            got = _step_grads(g_ours[name], g_old[name])
            if name.startswith("anchors."):
                ref, got = ref[active], got[active]
            _scaled_close(got, ref, f"step {i} grad {name}", tol=grad_tol)
        for name in ("opacity_accum", "anchor_demon", "offset_denom"):
            np.testing.assert_allclose(ours["stats"][name],
                                       new["stats"][name], rtol=1e-5,
                                       atol=1e-6, err_msg=f"step {i} {name}")
        _scaled_close(ours["stats"]["offset_grad_accum"],
                      new["stats"]["offset_grad_accum"],
                      f"step {i} offset_grad_accum")
        assert ours["step"] == int(new["step"]) == i + 1
        j_losses.append(float(jm["loss"]))
        ours_traj, m = t_step(ours_traj, cam_t, torch.tensor(gt),
                              torch.tensor(bg), **t_kw)
        t_losses.append(float(m["loss"]))
        state, jts = new, j_new
    assert state["stats"]["anchor_demon"].max() > 0  # the window was hit
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-3)
    if variant == "plain":  # (the other adds the frequency term at step 2)
        assert t_losses[-1] < t_losses[0]
