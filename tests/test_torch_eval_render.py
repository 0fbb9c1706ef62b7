"""The port's eval path against the JAX package on the CPU: the eval blend
(K3's plain version, both layouts, also on tiles deeper than two of the
kernel's batches; K4's plain version), EvalRenderer,
calibrate_eval_config, render_batch, Trainer.evaluate, and the recorder and
harness with the reference's files. Images within atol 2e-4 (as
tests/test_rasterizer.py), integer counts and configs equal. The kernels
themselves run only on a card: see the `cuda` test.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from segs_slam_tpu.core import Camera as JCamera
from segs_slam_tpu.core.keyframe import Keyframe as JKeyframe
from segs_slam_tpu.eval import harness as jharness
from segs_slam_tpu.eval import recorder as jrecorder
from segs_slam_tpu.models.anchors import empty_state, insert_points
from segs_slam_tpu.models.config import ModelConfig as JModelConfig
from segs_slam_tpu.models.decoders import init_decoders
from segs_slam_tpu.models.renderer import ChainedEvalRenderer
from segs_slam_tpu.models.renderer import EvalRenderer as JEvalRenderer
from segs_slam_tpu.models.renderer import (
    calibrate_eval_config as j_calibrate,
)
from segs_slam_tpu.ops.rasterizer import RasterConfig as JRasterConfig
from segs_slam_tpu.ops.rasterizer import binning as jbin
from segs_slam_tpu.ops.rasterizer import blend as jblend
from segs_slam_tpu.train.config import OptimizationConfig as JOptConfig
from segs_slam_tpu.train.trainer import Trainer as JTrainer
from segs_slam_tpu_torch.core import Camera, Keyframe
from segs_slam_tpu_torch.eval import harness, metrics
from segs_slam_tpu_torch.eval.recorder import record_all_keyframes
from segs_slam_tpu_torch.io.convert import (
    anchors_from_numpy,
    decoders_from_jax,
    flatten_params,
    train_state_from_jax,
)
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.models.renderer import (
    EvalRenderer,
    calibrate_eval_config,
)
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from segs_slam_tpu_torch.ops.rasterizer import binning as tbin
from segs_slam_tpu_torch.ops.rasterizer import blend as tblend
from segs_slam_tpu_torch.train.config import OptimizationConfig
from segs_slam_tpu_torch.train.trainer import Trainer
from test_torch_blend import _blend_inputs, stress_tiles
from test_torch_blend import _scene as blend_scene
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

W, H = 48, 32


def _scene(seed=3, n=40, appearance_dim=0, log_scale=np.log(0.3)):
    """tests/test_packed_binning.py:_scene on both sides: (JAX config,
    anchors, decoders, cam; the port's config, anchors, decoders, cam)."""
    kw = dict(feat_dim=8, n_offsets=4, appearance_dim=appearance_dim,
              embedding_dim=4, capacity=64, voxel_size=0.05)
    jmc = JModelConfig(**kw)
    rng = np.random.default_rng(seed)
    anchors, _ = insert_points(
        empty_state(jmc), rng.uniform([-1, -1, 2], [1, 1, 5], (n, 3)), jmc)
    anchors = anchors._replace(
        scaling=jnp.full_like(anchors.scaling, log_scale))
    params = init_decoders(jax.random.PRNGKey(0), jmc)
    kf_args = dict(kf_id=0, quat=[1, 0, 0, 0], trans=[0, 0, 0])
    jcam = JKeyframe(camera=JCamera(camera_id=0, width=W, height=H, fx=40.0,
                                    fy=40.0, cx=W / 2, cy=H / 2), **kf_args)
    cam = Keyframe(camera=Camera(camera_id=0, width=W, height=H, fx=40.0,
                                 fy=40.0, cx=W / 2, cy=H / 2), **kf_args)
    return (jmc, anchors, params,
            {k: jnp.asarray(v) for k, v in jcam.render_inputs().items()},
            ModelConfig(**kw),
            anchors_from_numpy({n: np.asarray(v) for n, v in
                                anchors._asdict().items()}),
            decoders_from_jax(flatten_params(params)),
            {k: torch.as_tensor(v) for k, v in cam.render_inputs().items()})


def _configs(**kw):
    return (JRasterConfig(tile=16, chunk=64, **kw),
            RasterConfig(tile=16, chunk=64, **kw))


def _projected(seed=7, appearance_dim=0):
    """The JAX package's blend inputs (feats, aux) of the scene, as numpy:
    both blends are then fed the same per-gaussian values."""
    jmc, anchors, params, jcam, *_ = _scene(seed, appearance_dim=appearance_dim)
    chained = ChainedEvalRenderer(jmc, JRasterConfig(tile=16, compact=256,
                                                     kmax=8, chunk=64),
                                  W, H, jnp.zeros(3), interpret=True)
    feats, aux = chained._project(chained._decode(anchors, params, jcam),
                                  jcam)
    return ([np.asarray(f) for f in feats],
            {k: np.asarray(v) for k, v in aux.items()})


def _latch_projected():
    """test_torch_blend's latch_batches scene through the JAX preprocess:
    (feats, aux, W, H), four tiles of 255-769 instances, deeper than two of
    the eval kernel's 128-instance batches, whose pixels latch anywhere from
    the first batch to the sixth, or never."""
    means, scales, quats, opac, colors, _, kf, w, h, cfg = blend_scene(
        "latch_batches")
    feats, aux = _blend_inputs(means, scales, quats, opac, colors, kf, w, h,
                               JRasterConfig(tile=16, **cfg))
    return feats, aux, w, h


BG = np.array([0.2, 0.4, 0.6], np.float32)

BLEND_CASES = [
    ("f16_dual_rate", dict(compact=256, kmax=8, ksmall=2, nlarge=64)),
    ("f16_three_tier", dict(compact=256, kmax=8, ksmall=2, kmid=4, nmid=128,
                            nlarge=64)),
    ("f16_overflow", dict(compact=32, kmax=8, ksmall=2, nlarge=16)),
    ("f16_direct", dict(compact=256, kmax=8, ksmall=2, nlarge=64,
                        sel_direct=True)),
    ("pack8_direct", dict(compact=256, kmax=8, ksmall=2, kmid=4, nmid=128,
                          nlarge=64, sel_direct=True, pack8=True)),
    ("pack8_appearance", dict(compact=256, kmax=8, ksmall=2, kmid=4,
                              nmid=128, nlarge=64, sel_direct=True,
                              pack8=True)),
    ("f16_latch", dict(compact=2048, kmax=4, ksmall=2, nlarge=1024)),
    # compact = N: JAX's bin_eval_direct cannot pad
    ("pack8_latch", dict(compact=1200, kmax=4, ksmall=2, nlarge=512,
                         sel_direct=True, pack8=True)),
]


@pytest.mark.parametrize("case,kw", BLEND_CASES)
def test_eval_blend_matches_jax(case, kw):
    """K3's plain version (through binned_blend_eval) against JAX's
    binned_blend_eval, whose K3 runs in interpret mode, on the same blend
    inputs: identical packed columns reach both kernels."""
    if "latch" in case:
        feats, aux, w, h = _latch_projected()
    else:
        feats, aux = _projected(appearance_dim=8 if "appearance" in case
                                else 0)
        w, h = W, H
    cj, ct = _configs(**kw)
    tx, ty = ct.grid(w, h)
    ref = jblend.binned_blend_eval(
        tuple(jnp.asarray(f) for f in feats),
        {k: jnp.asarray(v) for k, v in aux.items()}, jnp.asarray(BG),
        (cj, tx, ty, 256, True))
    ours = tblend.binned_blend_eval(
        torch.tensor(np.stack(feats)),
        {k: torch.tensor(v) for k, v in aux.items()}, torch.tensor(BG), ct,
        tx, ty)
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]),
                               atol=2e-4, rtol=0)
    assert ours[1] is None and ours[2] is None and ours[3] is None
    assert int(ours[4]) == int(ref[4]) and int(ours[5]) == int(ref[5])
    assert (ours[0] - torch.tensor(BG)[None, :, None]).abs().max() > 0.1
    if case == "f16_overflow":
        assert int(ours[5]) > kw["compact"]
    if "latch" in case:  # more than two batches a tile on average
        assert int(ours[4]) > 2 * 128 * tx * ty


def test_k4_plain_version_matches_jax_kernel():
    """K4's plain version against JAX's _fwd_kernel_eval, driven through
    _pallas_call as binned_blend_eval's f32 branch would drive it, on the
    same unpacked rows; and the port's packed_kernel=False branch."""
    feats, aux = _projected(seed=5)
    cj, ct = _configs(compact=256, kmax=8, ksmall=2, kmid=4, nmid=128,
                      nlarge=64)
    tx, ty = ct.grid(W, H)
    pc = jbin.compact_gaussians_packed(
        tuple(jnp.asarray(f) for f in feats),
        {k: jnp.asarray(v) for k, v in aux.items()}, cj)
    feats_sorted, start, stop, _, _ = jbin.expand_and_sort_packed(
        pc, tx, ty, cj)
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    static = (cj, tx, ty, 256, True)
    sup = jblend._pick_sup(tx)
    call = jblend._pallas_call(
        functools.partial(jblend._fwd_kernel_eval, cfg=cj, tx=tx, npix=256,
                          sup=sup), static,
        (jax.ShapeDtypeStruct((tx * ty, 3, 256), jnp.float32),),
        (pl.BlockSpec((sup, 3, 256), lambda i, *_: (i, 0, 0)),),
        [pl.BlockSpec(memory_space=pltpu.HBM),
         pl.BlockSpec(memory_space=pltpu.VMEM)],
        [pltpu.VMEM((2, jblend.NFEAT, cj.chunk), jnp.float32),
         pltpu.SemaphoreType.DMA((2,))], grid=(tx * ty // sup,))
    (ref,) = call(start, stop, jblend._stack_feats(feats_sorted,
                                                   cj.max_instances,
                                                   cj.chunk),
                  jnp.asarray(BG).reshape(3, 1))
    ours = tblend.blend_forward_eval_reference(
        torch.tensor(np.stack([np.asarray(f) for f in feats_sorted])),
        torch.tensor(np.asarray(start)), torch.tensor(np.asarray(stop)),
        torch.tensor(BG), tx, ct)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=0)
    via = tblend.binned_blend_eval(
        torch.tensor(np.stack(feats)),
        {k: torch.tensor(v) for k, v in aux.items()}, torch.tensor(BG), ct,
        tx, ty, packed_kernel=False)
    torch.testing.assert_close(via[0], ours, atol=0, rtol=0)
    assert np.abs(np.asarray(ref) - BG[None, :, None]).max() > 0.1


@pytest.mark.parametrize("case", ["f16", "pack8", "eval_variant",
                                  "appearance", "f32_fallback"])
def test_eval_renderer_matches_jax(case):
    appearance = 8 if case == "appearance" else 0
    jmc, anchors, params, jcam, mc, t_anchors, t_dec, cam = _scene(
        seed=11, appearance_dim=appearance)
    kw = dict(compact=256, kmax=8, ksmall=2, nlarge=64)
    if case == "pack8":
        kw.update(kmid=4, nmid=128, sel_direct=True, pack8=True)
    if case == "f32_fallback":  # kmax > 31: the training blend (K1)
        kw = dict(compact=256, kmax=32)
    cj, ct = _configs(**kw)
    if case in ("eval_variant", "appearance"):
        cj, ct = cj.eval_variant(W, H), ct.eval_variant(W, H)
        assert ct.pack8
    ref = JEvalRenderer(jmc, cj, W, H, jnp.asarray(BG), interpret=True)(
        anchors, params, jcam)
    renderer = EvalRenderer(mc, ct, W, H, torch.tensor(BG), device="cpu")
    assert renderer.packed == (case != "f32_fallback")
    got = renderer.render_with_counts(t_anchors, t_dec, cam)
    assert got["image"].shape == (3, H, W)
    np.testing.assert_allclose(got["image"].numpy(), np.asarray(ref),
                               atol=2e-4, rtol=0)
    assert (got["image"] - torch.tensor(BG)[:, None, None]).abs().max() > 0.1
    assert int(got["num_instances"]) > 0 and int(got["num_compact"]) > 0


def test_calibrate_eval_config_matches_jax():
    """The heavy-footprint scene of tests/test_packed_binning.py:502: the
    same calibrated config as JAX's, above the formula sizes, and the image
    within 2e-4 of JAX's EvalRenderer at that config."""
    jmc, anchors, params, jcam, mc, t_anchors, t_dec, cam = _scene(
        seed=23, n=60, log_scale=np.log(0.8))
    cj, ct = _configs(compact=256, kmax=8, ksmall=4, nlarge=64)
    cal_j = j_calibrate(cj, jmc, anchors, params, [jcam], W, H)
    cal_t = calibrate_eval_config(ct, mc, t_anchors, t_dec, [cam], W, H)
    assert dataclasses.asdict(cal_t) == dataclasses.asdict(cal_j)
    formula = ct.eval_variant(W, H)
    assert cal_t.nmid > formula.nmid or cal_t.nlarge > formula.nlarge
    ref = JEvalRenderer(jmc, cal_j, W, H, jnp.zeros(3), interpret=True)(
        anchors, params, jcam)
    got = EvalRenderer(mc, cal_t, W, H, torch.zeros(3), device="cpu")(
        t_anchors, t_dec, cam)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=0)
    assert float(got.max()) > 0.1
    # no packed path (a grid over 63 tiles): eval_variant's result as it is
    wide = calibrate_eval_config(ct, mc, t_anchors, t_dec, [cam], 1200, 680)
    assert wide == ct


def test_render_batch_equals_per_frame():
    jmc, anchors, params, jcam, mc, t_anchors, t_dec, _ = _scene(seed=13)
    ct = RasterConfig(tile=16, compact=256, kmax=8, chunk=64, ksmall=2,
                      nlarge=64).eval_variant(W, H)
    renderer = EvalRenderer(mc, ct, W, H, torch.zeros(3), device="cpu")
    cams = []
    for i in range(3):
        kf = Keyframe(kf_id=i, camera=Camera(
            camera_id=0, width=W, height=H, fx=40.0, fy=40.0, cx=W / 2,
            cy=H / 2), quat=[1.0, 0, 0, 0],
            trans=[0.03 * i, -0.02 * i, 0.05 * i])
        cams.append({k: torch.as_tensor(np.asarray(v, np.float32))
                     for k, v in kf.render_inputs().items()})
    singles = [renderer(t_anchors, t_dec, c) for c in cams]
    batch = renderer.render_batch(
        t_anchors, t_dec, {k: torch.stack([c[k] for c in cams])
                           for k in cams[0]})
    assert batch.shape == (3, 3, H, W)
    for i in range(3):
        torch.testing.assert_close(batch[i], singles[i], atol=0, rtol=0)
    assert not torch.equal(singles[0], singles[2]) and batch.max() > 0


# --- Trainer.evaluate and the recorder ------------------------------------

TW = TH = 32
SMALL = dict(feat_dim=8, n_offsets=4, appearance_dim=8, embedding_dim=4,
             capacity=64, voxel_size=0.05)
OPT = dict(start_stat=2, update_from=4, update_interval=5, update_until=100,
           use_frequency_regularization=False)
# compact = capacity * n_offsets: JAX's bin_eval_direct cannot pad
# (tests/test_torch_eval_binning.py::test_direct_pads_small_scenes)
RASTER = dict(tile=16, compact=256, kmax=8, chunk=64, ksmall=4, nlarge=64)


def _keyframes(cls_cam, cls_kf, n=3, seed=4):
    rng = np.random.default_rng(seed)
    cam = cls_cam(camera_id=0, width=TW, height=TH, fx=30.0, fy=30.0, cx=16,
                  cy=16)
    kfs = []
    for i in range(n):
        kf = cls_kf(kf_id=i, camera=cam, quat=[1, 0.02 * i, -0.01 * i, 0],
                    trans=[0.05 * i, 0, 0])
        img = rng.uniform(0.1, 0.9, (3, TH, TW)).astype(np.float32)
        img[:, :3, :5] = 0.0
        kf.image = img
        kfs.append(kf)
    return kfs


def _tree(x):
    if hasattr(x, "_asdict"):
        x = x._asdict()
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items()}
    return np.asarray(x)


@pytest.fixture(scope="module")
def trainers():
    """A JAX Trainer and the port's, with the same keyframes and map, after
    two JAX iterations (copied into the port)."""
    pts = np.random.default_rng(1).uniform([-0.8, -0.6, 1.5],
                                           [0.8, 0.6, 4.0], (40, 3))
    jt = JTrainer(JModelConfig(**SMALL), JOptConfig(**OPT),
                  JRasterConfig(**RASTER), TW, TH, seed=2, interpret=True)
    tt = Trainer(ModelConfig(**SMALL), OptimizationConfig(**OPT),
                 RasterConfig(**RASTER), TW, TH, seed=2, device="cpu")
    for trainer, classes in ((jt, (JCamera, JKeyframe)),
                             (tt, (Camera, Keyframe))):
        for kf in _keyframes(*classes):
            trainer.add_keyframe(kf)
    jt.initialize_map(pts)
    tt.initialize_map(pts, decoders=decoders_from_jax(
        flatten_params(jax.tree.map(np.asarray, jt.state.decoders))))
    for _ in range(2):
        jt.train_iteration()
    tt.state = train_state_from_jax(_tree(jt.state))
    tt.scene.kfs_used_times = dict(jt.scene.kfs_used_times)
    return jt, tt


def test_trainer_evaluate_matches_jax(trainers):
    """At one explicit eval config (JAX's Trainer skips the calibration on
    the CPU, trainer.py:563): the same metrics and keyframe images. Then the
    port's own calibration (which runs on every device) picks JAX's
    calibrated config from the same keyframes."""
    jt, tt = trainers
    cfg = RasterConfig(**RASTER).eval_variant(TW, TH)
    jt._eval_render_chain = JEvalRenderer(
        jt.model_config, JRasterConfig(**dataclasses.asdict(cfg)), TW, TH,
        jt._bg, interpret=True)
    tt._eval_renderer = EvalRenderer(tt.model_config, cfg, TW, TH, tt._bg,
                                     device="cpu")
    ref, ours = jt.evaluate(), tt.evaluate()
    assert ours["n_keyframes"] == ref["n_keyframes"] == 3
    for k in ("psnr", "ssim", "psnr_gs"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, err_msg=k)
    for kid, kf in tt.scene.keyframes.items():
        np.testing.assert_allclose(
            tt.render_keyframe(kf).numpy(),
            np.asarray(jt.render_keyframe(jt.scene.keyframes[kid])),
            atol=2e-4, rtol=0)

    tt.reset_eval_renderer()
    kfs = [kf for _, kf in sorted(jt.scene.keyframes.items())]
    cal_j = j_calibrate(jt.raster_config, jt.model_config, jt.state.anchors,
                        jt.state.decoders,
                        [jt.refined_cam(kf) for kf in kfs[:4]], TW, TH)
    renderer = tt.eval_renderer()
    assert dataclasses.asdict(renderer.raster_config) == \
        dataclasses.asdict(cal_j)
    assert tt.eval_renderer() is renderer  # calibrated once, then cached


def test_record_all_keyframes_and_harness(trainers, tmp_path, capsys):
    """The recorder writes the reference's files, which the port's harness
    and the JAX package's read alike; the JAX recorder's files read back
    through the port's harness too."""
    jt, tt = trainers
    res = record_all_keyframes(tt, tmp_path / "port",
                               tracking_times=[0.01, 0.02],
                               total_runtime_s=12.5)
    files = {p.name for p in (tmp_path / "port").iterdir()}
    assert files >= {"rendered", "ground_truth", "render_time.txt",
                     "render_time_per_dispatch.txt", "psnr.txt", "dssim.txt",
                     "psnr_gaussian_splatting.txt", "gaussians_num.txt",
                     "keyframe_used_times.txt", "TrackingTime.txt",
                     "RunningTime.txt"}
    assert "DevicePeakUsageMB.txt" not in files  # no CUDA device
    assert len(list((tmp_path / "port" / "rendered").glob("*.png"))) == 3
    assert np.isfinite(res["render_fps"]) and res["render_fps"] > 0

    run = harness.evaluate_run(tmp_path / "port")
    np.testing.assert_allclose(run["render_fps"], res["render_fps"],
                               rtol=1e-5)
    for k in ("psnr", "dssim", "psnr_gs"):
        np.testing.assert_allclose(run[k], res[k], rtol=1e-5)
    assert run["lpips_skipped"] == 1.0 and "lpips" not in run
    np.testing.assert_allclose(run["tracking_fps"], 1 / 0.015)
    assert jharness.evaluate_run(tmp_path / "port").keys() == run.keys()

    jrecorder.record_all_keyframes(jt, tmp_path / "jax")
    jfiles = {p.name for p in (tmp_path / "jax").iterdir()}
    assert jfiles - files <= {"DevicePeakUsageMB.txt"}
    jrun = harness.evaluate_run(tmp_path / "jax")
    assert np.isfinite(jrun["render_fps"]) and jrun["psnr"] > 0
    rows = harness.aggregate(tmp_path)
    assert len(rows) == 2 and (tmp_path / "log.csv").is_file()
    capsys.readouterr()


def test_lpips_is_not_ported(monkeypatch):
    """Without weights lpips_fn gives None, unset or missing, as JAX's does
    (LPIPS itself is held to JAX in test_torch_lpips.py)."""
    monkeypatch.delenv("SEGS_LPIPS_WEIGHTS", raising=False)
    assert metrics.lpips_fn() is None
    monkeypatch.setenv("SEGS_LPIPS_WEIGHTS", "/nonexistent/alexnet.npz")
    assert metrics.lpips_fn() is None


def test_eval_blend_dispatch_and_guards():
    cfg = RasterConfig(tile=16, compact=64, kmax=8, chunk=64)
    cfg8 = RasterConfig(tile=16, compact=64, kmax=8, chunk=64, ksmall=2,
                        nlarge=8, sel_direct=True, pack8=True)
    g = torch.Generator().manual_seed(0)
    start = torch.tensor([0, 10], dtype=torch.int32)
    stop = torch.tensor([10, 32], dtype=torch.int32)
    bg = torch.zeros(3)
    before = (tblend.blend_forward_eval_packed_cuda.launches,
              tblend.blend_forward_eval_cuda.launches)
    for c, rows in ((cfg, 5), (cfg8, 4)):
        cols = torch.randint(-2**31, 2**31 - 1, (rows, 32), generator=g,
                             dtype=torch.int32)
        got = tblend.blend_forward_eval_packed(cols, start, stop, bg, 2, c)
        want = tblend.blend_forward_eval_packed_reference(cols, start, stop,
                                                          bg, 2, c)
        torch.testing.assert_close(got, want, atol=0, rtol=0, equal_nan=True)
        with pytest.raises(ValueError):  # the kernel wrapper never takes CPU
            tblend.blend_forward_eval_packed_cuda(cols, start, stop, bg, 2, c)
        with pytest.raises(ValueError, match=r"\[%d, NK\]" % rows):
            tblend.blend_forward_eval_packed_cuda(cols[:3], start, stop, bg,
                                                  2, c)
    feats = torch.rand(tblend.NFEAT, 32, generator=g)
    assert torch.equal(
        tblend.blend_forward_eval(feats, start, stop, bg, 2, cfg),
        tblend.blend_forward_reference(feats, start, stop, bg, 2, cfg)[0])
    with pytest.raises(ValueError):
        tblend.blend_forward_eval_cuda(feats, start, stop, bg, 2, cfg)
    assert (tblend.blend_forward_eval_packed_cuda.launches,
            tblend.blend_forward_eval_cuda.launches) == before

    n = 8
    pay = torch.rand(tblend.NPAY, n, generator=g)
    aux = {"rect_min_x": torch.zeros(n, dtype=torch.int32),
           "rect_min_y": torch.zeros(n, dtype=torch.int32),
           "rect_w": torch.ones(n, dtype=torch.int32),
           "touched": torch.ones(n, dtype=torch.int32),
           "depth": torch.rand(n, generator=g) + 1,
           "alive": torch.ones(n, dtype=torch.bool)}
    with pytest.raises(ValueError, match="packed kernel"):
        tblend.binned_blend_eval(pay, aux, bg, cfg8, 2, 1,
                                 packed_kernel=False)
    out = tblend.binned_blend_eval(pay, aux, bg, cfg8, 2, 1)
    assert out[0].shape == (2, 3, 256) and int(out[4]) == n


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K3 and K4 are CUDA C++ with no CPU "
                    "mode)")
    return torch.device("cuda")


def _random_stacks(g, tx, ty, max_count=3000):
    counts = torch.randint(0, max_count, (tx * ty,), generator=g,
                           dtype=torch.int32)
    stop = torch.cumsum(counts, 0).to(torch.int32)
    return stop - counts, stop, int(stop[-1]) + 5


CFG = RasterConfig(tile=16, compact=64, kmax=8)
CFG8 = RasterConfig(tile=16, compact=64, kmax=8, ksmall=2, nlarge=8,
                    sel_direct=True, pack8=True)


def _eval_layouts(local, absolute, zero_op=None):
    """(kernel, plain version, input, config) for K3's f16 and pack8 columns
    of the rows `local` (mean2d tile-local; quantised to pack8's bytes and
    11-bit opacity, which is 0 where zero_op is set) and K4's f32 rows
    `absolute`."""
    def q(v, levels):
        return torch.round(v.clamp(0, 1) * levels).to(torch.int64)

    pack = tbin._pack2f16
    f16_cols = torch.stack([
        pack(local[0], local[1]), pack(local[2], local[3]),
        pack(local[4], local[5]), pack(local[6], local[7]),
        tbin._f16_bits(local[8])])
    op8 = q(local[5], 2047)
    if zero_op is not None:
        op8 = torch.where(zero_op, 0, op8)
    pack8_cols = torch.stack([
        f16_cols[0], f16_cols[1], tbin._f16_bits(local[4]) | (op8 << 16),
        q(local[6], 255) | (q(local[7], 255) << 8) | (q(local[8], 255) << 16)])
    packed = (tblend.blend_forward_eval_packed_cuda,
              tblend.blend_forward_eval_packed_reference)
    return [(*packed, tbin.as_u32_bits(f16_cols), CFG),
            (*packed, tbin.as_u32_bits(pack8_cols), CFG8),
            (tblend.blend_forward_eval_cuda,
             tblend.blend_forward_eval_reference, absolute, CFG)]


def _assert_eval_kernels_match(layouts, start, stop, bg, tx, dev,
                               monkeypatch):
    """Each layout's kernel at every pixels-a-thread instance against its
    plain version on the card (whose torch.exp is the kernel's expf):
    colour within 2e-4 on every pixel."""
    start, stop, bg = (x.to(dev) for x in (start, stop, bg))
    for kernel, plain, x, c in layouts:
        x = x.to(dev)
        ref = plain(x, start, stop, bg, tx, c)
        assert float((ref - bg[None, :, None]).abs().max()) > 0.1
        for p in tblend.KERNEL_PIXELS:  # each instance of the kernel
            monkeypatch.setattr(tblend, "_pixels_per_thread", lambda *_: p)
            got = kernel(x, start, stop, bg, tx, c)
            torch.cuda.synchronize()
            assert float((got - ref).abs().max()) <= 2e-4, (c.pack8, p)


@pytest.mark.cuda
def test_eval_kernels_match_plain_versions(cuda_device, monkeypatch):
    """K3 (both layouts) and K4 against their plain versions at every
    pixels-a-thread instance, on random deep tile stacks and on a
    tile-local packing of test_torch_blend.stress_tiles (odd starts, empty
    tiles, 1-1,000-instance ranges, latches in batch 1 to 8 or never,
    opacities at the clamp; here also needle-shaped conics, and under pack8
    some opacities 0); and the whole
    EvalRenderer on the card against the CPU path."""
    g = torch.Generator().manual_seed(0)
    tx, ty = 6, 4
    start, stop, nk = _random_stacks(g, tx, ty)
    f = torch.rand(tblend.NFEAT, nk, generator=g)
    f[2:5] = f[2:5] * torch.tensor([0.05, 0.01, 0.05])[:, None] \
        + torch.tensor([0.01, -0.005, 0.01])[:, None]
    f[5] *= 0.6
    bg = torch.tensor([0.1, 0.2, 0.3])
    local = f.clone()
    local[0:2] = local[0:2] * 24 - 4  # tile-local, a little outside
    absolute = f.clone()
    absolute[0] *= tx * 16
    absolute[1] *= ty * 16
    _assert_eval_kernels_match(_eval_layouts(local, absolute), start, stop,
                               bg, tx, cuda_device, monkeypatch)

    f, start, stop, tx = stress_tiles(torch.Generator().manual_seed(1))
    # every eleventh instance a needle (a c / det = 500, or more once its
    # conic is rounded to f16), where the kernels' band test is tightest
    needle = torch.arange(f.shape[1]) % 11 == 5
    f[3] = torch.where(needle, 0.999 * (f[2] * f[4]).sqrt() * torch.where(
        f[0] > f[1], 1.0, -1.0), f[3])
    counts = (stop - start).long()
    tile = torch.repeat_interleave(torch.arange(counts.numel()), counts)
    cols = slice(int(start[0]), int(stop[-1]))  # the ranges are contiguous
    local = f.clone()
    local[0, cols] -= (tile % tx * 16).float()
    local[1, cols] -= (tile // tx * 16).float()
    zero_op = torch.arange(f.shape[1]) % 37 == 0
    ref = tblend.blend_forward_reference(
        *(x.to(cuda_device) for x in (f, start, stop, bg)), tx, CFG)
    assert int(ref[3].max()) > 512 and (ref[1] < 1e-3).any()  # deep latches
    _assert_eval_kernels_match(_eval_layouts(local, f, zero_op), start,
                               stop, bg, tx, cuda_device, monkeypatch)

    _, _, _, _, mc, anchors, dec, cam = _scene(seed=11, appearance_dim=8)
    ct = RasterConfig(tile=16, compact=256, kmax=8, chunk=64, ksmall=2,
                      nlarge=64).eval_variant(W, H)
    imgs = []
    for dev in ("cpu", cuda_device):
        imgs.append(EvalRenderer(mc, ct, W, H, bg, device=dev)(
            anchors_from_numpy({f.name: getattr(anchors, f.name).numpy()
                                for f in dataclasses.fields(anchors)}, dev),
            dec.to(dev),
            {k: v.to(dev) for k, v in cam.items()}).cpu())
    np.testing.assert_allclose(imgs[1].numpy(), imgs[0].numpy(), atol=2e-4)
