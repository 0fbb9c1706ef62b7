"""The port's data-parallel step (parallel/dp.py on torch.distributed) in
two gloo ranks on the CPU, against the JAX package's make_dp_train_step on
a 2-device mesh (conftest's virtual CPU devices) and against the port's
single-process step, from one seeded state (tests/test_dp.py's scene):

  - replicated inputs reproduce the single step's update (rtol 1e-4, atol
    1e-5, tests/test_dp.py's tolerances) and JAX's dp update;
  - the densify statistics gather twice the single step's delta;
  - with a keyframe a rank, the loss is the mean of the ranks' losses, and
    the two ranks hold the same state after the step;
  - a second step advances as JAX's does.

The ranks start once for the module (one subprocess each, rendezvous
through a file under the test's tmp dir, so parallel workers never share a
port); the JAX mesh steps run meanwhile.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from segs_slam_tpu.core import Camera as JCamera
from segs_slam_tpu.core.keyframe import Keyframe as JKeyframe
from segs_slam_tpu.models.anchors import empty_state, insert_points
from segs_slam_tpu.models.config import ModelConfig as JModelConfig
from segs_slam_tpu.models.decoders import init_decoders
from segs_slam_tpu.ops.rasterizer import RasterConfig as JRasterConfig
from segs_slam_tpu.parallel.dp import make_dp_train_step as j_make_dp
from segs_slam_tpu.train.config import OptimizationConfig as JOptConfig
from segs_slam_tpu.train.step import init_train_state
from segs_slam_tpu_torch.io.convert import (
    train_state_from_jax,
    train_state_to_numpy,
)
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from segs_slam_tpu_torch.train.config import OptimizationConfig
from segs_slam_tpu_torch.train.step import make_train_step
from test_torch_trainer import _flat, _tree
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

W = H = 32
RANKS = 2
MC = dict(feat_dim=8, n_offsets=4, appearance_dim=8, embedding_dim=4,
          capacity=64, voxel_size=0.05)
OC = dict(start_stat=0, update_from=4, update_interval=5, update_until=100,
          use_frequency_regularization=False)
RC = dict(tile=16, compact=512, kmax=16, chunk=64)
ROOT = Path(__file__).resolve().parents[1]

RANK = """
import copy, pickle, sys
import numpy as np
import torch
import torch.distributed as dist
from segs_slam_tpu_torch.io.convert import train_state_from_jax, \\
    train_state_to_numpy
from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from segs_slam_tpu_torch.parallel.dp import make_dp_train_step
from segs_slam_tpu_torch.train.config import OptimizationConfig

rank, world, init, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                               *sys.argv[3:])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=init, world_size=world,
                        rank=rank)
d = pickle.load(open(inp, "rb"))
step = make_dp_train_step(dist.group.WORLD, ModelConfig(**d["mc"]),
                          OptimizationConfig(**d["oc"]),
                          RasterConfig(**d["rc"]), d["w"], d["h"])
dev = torch.device(d["device"])
cam = {k: torch.as_tensor(v, device=dev) for k, v in d["cam"].items()}
bg = torch.zeros(3, device=dev)
res = {}
ts = None
for case, gt in (("replicated", d["gt"]), ("second", d["gt"]),
                 ("distinct", d["gts"][rank])):
    if case != "second":
        ts = train_state_from_jax(d["state"], dev)
    ts, m = step(ts, cam, torch.as_tensor(gt, device=dev), bg)
    # copied: on the CPU the numpy arrays share the state's memory, which
    # the next step updates in place
    res[case] = copy.deepcopy((train_state_to_numpy(ts),
                               {k: np.asarray(v.cpu()) for k, v in m.items()}))
pickle.dump(res, open(out, "wb"))
dist.destroy_process_group()
"""


def _compared(tree):
    """The map, decoder and statistics leaves of a nested state tree."""
    return {k: v for k, v in _flat(tree).items()
            if k.startswith(("anchors.", "decoders.", "stats."))}


def _assert_states_close(got, ref, rtol=1e-4, atol=1e-5):
    got, ref = _compared(got), _compared(ref)
    assert got.keys() == ref.keys()
    for name, val in ref.items():
        np.testing.assert_allclose(got[name], val, rtol=rtol, atol=atol,
                                   err_msg=name)


def _scene():
    """tests/test_dp.py's scene: (initial JAX state, gt, per-rank gts,
    camera inputs as numpy)."""
    jmc = JModelConfig(**MC)
    rng = np.random.default_rng(0)
    pts = rng.uniform([-0.8, -0.6, 1.5], [0.8, 0.6, 4.0], size=(40, 3))
    anchors, _ = insert_points(empty_state(jmc), pts, jmc)
    ts0 = init_train_state(anchors, init_decoders(jax.random.PRNGKey(0), jmc),
                           jmc)
    gt = np.clip(rng.uniform(0.1, 0.9, (3, H, W)), 0, 1).astype(np.float32)
    gts = np.random.default_rng(7).uniform(0, 1, (RANKS, 3, H, W)).astype(
        np.float32)
    cam = JCamera(camera_id=0, width=W, height=H, fx=30.0, fy=30.0, cx=16,
                  cy=16)
    kf = JKeyframe(kf_id=0, camera=cam, quat=[1, 0, 0, 0], trans=[0, 0, 0])
    cam_np = {k: np.asarray(v, np.float32)
              for k, v in kf.render_inputs().items()}
    return ts0, gt, gts, cam_np


def _start_ranks(tmp: Path, ts0, gt, gts, cam_np, device: str):
    """Start the RANKS rank processes on `device`; returns a function that
    waits for them and gives their results."""
    inp = tmp / "inputs.pkl"
    with open(inp, "wb") as f:
        pickle.dump({"state": _tree(ts0), "cam": cam_np, "gt": gt,
                     "gts": gts, "mc": MC, "oc": OC, "rc": RC, "w": W,
                     "h": H, "device": device}, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(RANKS),
         f"file://{tmp / 'rendezvous'}", str(inp), str(tmp / f"rank{r}.pkl")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(RANKS)]

    def results():
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log
        return [pickle.load(open(tmp / f"rank{r}.pkl", "rb"))
                for r in range(RANKS)]
    return results


def _port_single(ts0, cam_np, gts: dict, device="cpu") -> dict:
    """The port's single-process step from the initial state on each named
    gt: {name: (state tree, metrics)}."""
    step = make_train_step(ModelConfig(**MC), OptimizationConfig(**OC),
                           RasterConfig(**RC), W, H)
    cam_t = {k: torch.as_tensor(v, device=device) for k, v in cam_np.items()}
    out = {}
    for name, g in gts.items():
        ts, m = step(train_state_from_jax(_tree(ts0), device), cam_t,
                     torch.as_tensor(g, device=device),
                     torch.zeros(3, device=device))
        out[name] = (train_state_to_numpy(ts),
                     {k: np.asarray(v.cpu() if torch.is_tensor(v) else v)
                      for k, v in m.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, the JAX dp and single steps' and the port's
    single steps', from one initial state."""
    ts0, gt, gts, cam_np = _scene()
    results = _start_ranks(tmp_path_factory.mktemp("dp"), ts0, gt, gts,
                           cam_np, "cpu")
    # JAX meanwhile: the dp step on a 2-device mesh
    jmc, jrc, joc = JModelConfig(**MC), JRasterConfig(**RC), JOptConfig(**OC)
    cam_b = {k: jnp.broadcast_to(jnp.asarray(v), (RANKS,) + v.shape)
             for k, v in cam_np.items()}
    gt_b = jnp.broadcast_to(jnp.asarray(gt), (RANKS,) + gt.shape)
    mesh = Mesh(np.array(jax.devices()[:RANKS]), axis_names=("dp",))
    dp = j_make_dp(mesh, jmc, joc, jrc, W, H)
    bg = jnp.zeros(3)
    with mesh:
        jd1, jm1 = dp(ts0, cam_b, gt_b, bg)
        jd2, jm2 = dp(jd1, cam_b, gt_b, bg)
        jdd, jmd = dp(ts0, cam_b, jnp.asarray(gts), bg)
    jax_res = {"replicated": (_tree(jd1), jm1), "second": (_tree(jd2), jm2),
               "distinct": (_tree(jdd), jmd)}
    single = _port_single(ts0, cam_np, dict(
        [("replicated", gt)] + [(f"rank{r}", gts[r]) for r in range(RANKS)]))
    return {"ranks": results(), "jax": jax_res, "single": single,
            "initial": _tree(ts0)}


def test_replicated_inputs_reproduce_single_step(runs):
    """Averaged gradients of equal inputs are the single step's: the dp
    update equals the port's single step and JAX's dp step; the loss
    metrics equal the single step's."""
    state, m = runs["ranks"][0]["replicated"]
    single, ms = runs["single"]["replicated"]
    _assert_states_close({k: v for k, v in state.items() if k != "stats"},
                         {k: v for k, v in single.items() if k != "stats"})
    _assert_states_close(state, runs["jax"]["replicated"][0])
    jm = runs["jax"]["replicated"][1]
    for key in ("loss", "l1", "psnr", "ssim"):
        np.testing.assert_allclose(m[key], ms[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)
        np.testing.assert_allclose(m[key], float(jm[key]), rtol=1e-4,
                                   err_msg=key)
    assert int(state["step"]) == 1 and int(m["nonfinite_grads"]) == 0
    assert int(m["num_instances"]) == int(jm["num_instances"]) > 0


def test_stats_are_twice_the_single_delta(runs):
    """The densify statistics are summed over the ranks: one dp step over
    two keyframes gathers twice a single step's delta, as JAX's psum."""
    state = _compared(runs["ranks"][1]["replicated"][0])
    single = _compared(runs["single"]["replicated"][0])
    init = _compared(runs["initial"])
    jax_dp = _compared(runs["jax"]["replicated"][0])
    stats = [k for k in state if k.startswith("stats.")]
    assert len(stats) == 4
    for k in stats:
        assert np.abs(single[k] - init[k]).max() > 0, k
        np.testing.assert_allclose(state[k] - init[k],
                                   RANKS * (single[k] - init[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(state[k], jax_dp[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_loss_is_mean_of_rank_losses(runs):
    """A keyframe a rank: the loss is the mean of the ranks' own single-
    step losses, and JAX's dp loss; both ranks hold the same state, and it
    is JAX's dp state."""
    (s0, m0), (s1, m1) = (r["distinct"] for r in runs["ranks"])
    per = [float(runs["single"][f"rank{r}"][1]["loss"])
           for r in range(RANKS)]
    np.testing.assert_allclose(float(m0["loss"]), np.mean(per), rtol=1e-5)
    np.testing.assert_allclose(float(m0["loss"]),
                               float(runs["jax"]["distinct"][1]["loss"]),
                               rtol=1e-4)
    a, b = _compared(s0), _compared(s1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _assert_states_close(s0, runs["jax"]["distinct"][0])
    assert int(m0["num_instances"]) == max(
        int(runs["single"][f"rank{r}"][1]["num_instances"])
        for r in range(RANKS))


def test_second_step_advances(runs):
    state, m = runs["ranks"][0]["second"]
    jstate, jm = runs["jax"]["second"]
    assert int(state["step"]) == 2
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    assert float(m["loss"]) < float(runs["ranks"][0]["replicated"][1]
                                     ["loss"]) + 0.05
    _assert_states_close(state, jstate)


@pytest.mark.cuda
def test_dp_step_on_card(tmp_path):
    """Two gloo ranks on one card (NCCL refuses two ranks on one device):
    the dp step through K1 and K2 on replicated inputs equals the
    single-process step on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ts0, gt, gts, cam_np = _scene()
    ranks = _start_ranks(tmp_path, ts0, gt, gts, cam_np, "cuda")()
    single = _port_single(ts0, cam_np, {"replicated": gt}, "cuda")
    got, ref = ranks[0]["replicated"][0], single["replicated"][0]
    _assert_states_close({k: v for k, v in got.items() if k != "stats"},
                         {k: v for k, v in ref.items() if k != "stats"})
