"""The port's web viewer (apps/viewer.py) on the CPU: the fly-control pose
against the JAX package's (atol 1e-6); checkpoint mode's frame of a map
trained a few JAX steps and carried across by train_state_from_jax against
JAX's EvalRenderer image of that map at the same pose (within one 8-bit
level); the HTTP server's routes on a free port; and the live viewer
serving frames while the mapper trains, each render under the Trainer's
lock. Every server a test starts is shut down.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from segs_slam_tpu.apps import viewer as jviewer
from segs_slam_tpu.core.camera import Camera as JCamera
from segs_slam_tpu.core.keyframe import Keyframe as JKeyframe
from segs_slam_tpu.models.config import ModelConfig as JModelConfig
from segs_slam_tpu.models.renderer import EvalRenderer as JEvalRenderer
from segs_slam_tpu.models.renderer import (
    calibrate_eval_config as j_calibrate,
)
from segs_slam_tpu.ops.rasterizer import RasterConfig as JRasterConfig
from segs_slam_tpu_torch.apps import viewer
from segs_slam_tpu_torch.core.camera import Camera
from segs_slam_tpu_torch.io.checkpoint import save_train_state
from segs_slam_tpu_torch.io.convert import train_state_from_jax
from segs_slam_tpu_torch.models import renderer as trenderer
from segs_slam_tpu_torch.slam.mapper import Mapper, MapperConfig
from segs_slam_tpu_torch.slam.producers import SyntheticOracleProducer
from segs_slam_tpu_torch.slam.protocol import MappingQueue
from test_torch_mapper import _port_setup, _sparse_fn
from test_torch_trainer import SMALL, _tree, trained_jax_state  # noqa: F401
from test_torch_core import two_torch_threads  # noqa: F401 (autouse)

POSES = [([0.1, -0.2, -1.0], 0.0, 0.0), ([0.3, 0.1, 0.5], 0.4, -0.3),
         ([-1.0, 0.5, 2.0], -2.5, 1.2), ([0.0, 0.0, 0.0], 3.0, -1.4)]
SIZE = 64
VIEW = dict(compact=256, kmax=8, ksmall=4, nlarge=64)


def _get(port, path, timeout=60):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=timeout) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _frame(body) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))


def test_pose_to_cam_inputs_matches_jax():
    jcam = JCamera(camera_id=0, width=SIZE, height=SIZE, fx=0.9 * SIZE,
                   fy=0.9 * SIZE, cx=SIZE / 2, cy=SIZE / 2)
    cam = Camera(camera_id=0, width=SIZE, height=SIZE, fx=0.9 * SIZE,
                 fy=0.9 * SIZE, cx=SIZE / 2, cy=SIZE / 2)
    for pos, yaw, pitch in POSES:
        ref = jviewer._pose_to_cam_inputs(pos, yaw, pitch, jcam)
        ours = viewer._pose_to_cam_inputs(pos, yaw, pitch, cam)
        assert ours.keys() == ref.keys()
        for k, v in ref.items():
            assert ours[k].dtype == torch.float32, k
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(v),
                                       atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def checkpoint(trained_jax_state, tmp_path_factory):  # noqa: F811
    """The trained JAX map as the port's train state file."""
    path = tmp_path_factory.mktemp("viewer") / "ckpt"
    save_train_state(path, train_state_from_jax(_tree(trained_jax_state)))
    return path


def test_checkpoint_frame_matches_jax(
        trained_jax_state, checkpoint):  # noqa: F811
    """build_renderer's frames of the trained map against JAX's viewer
    render (calibrate_eval_config on the centroid view, EvalRenderer, the
    same uint8 quantisation) at the same poses: within one 8-bit level."""
    args = viewer.parse_args(
        ["--ckpt", str(checkpoint), "--size", str(SIZE), "--capacity",
         str(SMALL["capacity"]), "--device", "cpu"]
        + [x for k, v in VIEW.items() for x in (f"--{k}", str(v))])
    render_pose, start, (w, h) = viewer.build_renderer(args)
    assert (w, h) == (SIZE, SIZE)

    ts = trained_jax_state
    jmc = JModelConfig(**SMALL)
    active = np.asarray(ts.anchors.active)
    center = np.asarray(ts.anchors.anchor)[active].mean(axis=0)
    np.testing.assert_allclose(start, center + [0.0, 0.0, -1.5], atol=1e-6)
    jcam = JCamera(camera_id=0, width=w, height=h, fx=0.9 * w, fy=0.9 * w,
                   cx=w / 2, cy=h / 2)
    kf0 = JKeyframe(kf_id=0, camera=jcam, quat=[1, 0, 0, 0],
                    trans=(-center).tolist())
    rc = j_calibrate(JRasterConfig(tile=16, chunk=256, **VIEW), jmc,
                     ts.anchors, ts.decoders,
                     [{k: jnp.asarray(v)
                       for k, v in kf0.render_inputs().items()}], w, h)
    chain = JEvalRenderer(jmc, rc, w, h, jnp.zeros(3), interpret=True)
    lit = 0
    for pos, yaw, pitch in [(start, 0.0, 0.0), (start, 0.15, -0.1)]:
        img = np.asarray(chain(ts.anchors, ts.decoders,
                               jviewer._pose_to_cam_inputs(pos, yaw, pitch,
                                                           jcam)))
        ref = (np.clip(np.transpose(img, (1, 2, 0)), 0, 1) * 255).astype(
            np.uint8)
        got = render_pose(pos, yaw, pitch)
        assert got.shape == (SIZE, SIZE, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
        lit += int((ref > 0).sum())
    assert lit > 100

    args.capacity = 128
    with pytest.raises(SystemExit, match="capacity"):
        viewer.build_renderer(args)


def test_server_routes():
    """/ (the page at the frame size), /state, /render (a JPEG of
    render_pose's frame) and a 404, on a port the OS picks."""
    seen = []

    def render_pose(pos, yaw, pitch):
        seen.append((pos, yaw, pitch))
        img = np.zeros((24, 32, 3), np.uint8)
        img[:, :16] = 200
        return img

    srv = viewer.make_server(render_pose, lambda: [1.0, 2.0, 3.0], 32, 24, 0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        port = srv.server_address[1]
        code, ctype, body = _get(port, "/")
        assert code == 200 and ctype == "text/html"
        assert b'width="32" height="24"' in body
        code, ctype, body = _get(port, "/state")
        assert json.loads(body) == {"pos": [1.0, 2.0, 3.0], "yaw": 0.0}
        code, ctype, body = _get(port,
                                 "/render?x=1&y=-2&z=0.5&yaw=0.3&pitch=-1")
        assert code == 200 and ctype == "image/jpeg"
        frame = _frame(body)
        assert frame.shape == (24, 32, 3)
        assert abs(int(frame[12, 4, 0]) - 200) <= 3
        assert frame[12, 28].max() <= 3
        assert seen == [([1.0, -2.0, 0.5], 0.3, -1.0)]
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(port, "/nope")
        assert e.value.code == 404
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)


def test_serve_live_during_mapping(monkeypatch):
    """serve_live on a Trainer before and while the Mapper trains: grey
    frames and the default position before the map exists; then a client
    thread's renders, every one 200 and rendered under the Trainer's lock,
    interleave with the mapper's iterations."""
    cam, kfs, trainer = _port_setup()
    under_lock = []
    call = trenderer.EvalRenderer.__call__

    def checked(self, *a):
        under_lock.append(trainer.lock.locked())
        return call(self, *a)

    monkeypatch.setattr(trenderer.EvalRenderer, "__call__", checked)
    th = viewer.serve_live(trainer, port=0, size=32)
    try:
        port = th.server.server_address[1]
        assert th.daemon and th.is_alive()
        code, _, body = _get(port, "/render")
        assert code == 200 and (np.abs(_frame(body).astype(int) - 64)
                                <= 2).all()
        assert json.loads(_get(port, "/state")[2])["pos"] == [0.0, 0.0, -2.0]

        queue = MappingQueue()
        SyntheticOracleProducer(
            kfs, cam, queue,
            sparse_points_fn=_sparse_fn(np.random.default_rng(1))).run()
        mapper = Mapper(queue, trainer, cam,
                        MapperConfig(min_num_initial_map_kfs=3))
        codes, stop = [], threading.Event()

        def client():
            while not stop.is_set() or len(codes) < 3:
                codes.append(_get(port, "/render?z=-1.5")[0])

        ct = threading.Thread(target=client)
        ct.start()
        try:
            mapper.run(max_iterations=12)
        finally:
            stop.set()
            ct.join(timeout=120)
        assert trainer.iteration == 12
        assert len(codes) >= 3 and set(codes) == {200}
        assert under_lock and all(under_lock)
        frame = _frame(_get(port, "/render?z=-1.5")[2])
        assert frame.shape == (32, 32, 3) and frame.std() > 0
        pos = json.loads(_get(port, "/state")[2])["pos"]
        center = trainer.state.anchors.anchor[
            trainer.state.anchors.active].mean(dim=0)
        np.testing.assert_allclose(pos, center.numpy() + [0, 0, -1.5],
                                   atol=1e-5)
        assert not th.errors
    finally:
        th.server.shutdown()
        th.server.server_close()
        th.join(timeout=10)
    assert not th.is_alive()


@pytest.mark.cuda
def test_checkpoint_frame_on_card_matches_cpu(checkpoint):
    """build_renderer's frame on the card (K3) within one 8-bit level of
    the CPU path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (K3 is CUDA C++ with no CPU mode)")
    frames = []
    for dev in ("cpu", "cuda"):
        args = viewer.parse_args(
            ["--ckpt", str(checkpoint), "--size", str(SIZE), "--capacity",
             str(SMALL["capacity"]), "--device", dev]
            + [x for k, v in VIEW.items() for x in (f"--{k}", str(v))])
        render_pose, start, _ = viewer.build_renderer(args)
        frames.append(render_pose(start, 0.1, -0.05).astype(int))
    assert np.abs(frames[1] - frames[0]).max() <= 1 and frames[0].max() > 0
