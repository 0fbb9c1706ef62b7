"""Interactive web viewer: free-view rendering of a map, from a checkpoint
or live from the running mapper.

Port of segs_slam_tpu/apps/viewer.py. The reference ships a GLFW/ImGui
viewer that draws free-view renders through GaussianMapper::renderFromPose
(reference: viewer/imgui_viewer.cpp, src/gaussian_mapper.cpp:2484-2538).
Headless hosts have no GL stack, so, as in the JAX package, a stdlib HTTP
server renders JPEG frames on demand through `EvalRenderer` (the packed
eval binning and kernel K3), and the browser page gives WASD + mouse-drag
fly controls.

Two modes:
  * checkpoint mode (this module's CLI): render the train state
    io/checkpoint.py:save_train_state wrote (`train_colmap --out` writes it
    to <out>/ckpt);
  * live mode (`serve_live`, the SLAM apps' --viewer-port): render the
    running mapper's map. The port's state is updated in place (Adam, the
    densify adjust's permutations), so each render holds the Trainer's
    lock, which the Trainer holds across each train iteration: the
    reference's render mutex.

Usage:
  python -m segs_slam_tpu_torch.apps.viewer --ckpt <out>/ckpt [--port 8600]
      [--size 480] [--capacity 16384] [--device cuda]
then open http://localhost:8600/
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from segs_slam_tpu_torch.core import se3
from segs_slam_tpu_torch.core.camera import Camera
from segs_slam_tpu_torch.core.keyframe import Keyframe
from segs_slam_tpu_torch.models.renderer import (
    EvalRenderer,
    calibrate_eval_config,
)

PAGE = """<!doctype html>
<html><head><title>segs_slam_tpu_torch viewer</title><style>
body { background:#111; color:#ddd; font-family:monospace; margin:0 }
#hud { position:fixed; top:8px; left:8px; background:#000a; padding:6px }
img { display:block; margin:0 auto; image-rendering:pixelated }
</style></head><body>
<div id="hud">WASD move &middot; QE up/down &middot; drag to look &middot;
<span id="st"></span></div>
<img id="v" width="__W__" height="__H__">
<script>
let pos = null, yaw = 0, pitch = 0, busy = false, dirty = true;
const keys = {};
fetch('/state').then(r => r.json()).then(s => { pos = s.pos; yaw = s.yaw; });
window.addEventListener('keydown', e => keys[e.key.toLowerCase()] = true);
window.addEventListener('keyup', e => keys[e.key.toLowerCase()] = false);
let drag = null;
const img = document.getElementById('v');
img.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => {
  if (!drag) return;
  yaw += (e.clientX - drag[0]) * 0.005;
  pitch += (e.clientY - drag[1]) * 0.005;
  pitch = Math.max(-1.5, Math.min(1.5, pitch));
  drag = [e.clientX, e.clientY];
  dirty = true;
});
function step() {
  if (pos) {
    const sp = 0.04;
    const fw = [Math.sin(yaw)*Math.cos(pitch), Math.sin(pitch),
                Math.cos(yaw)*Math.cos(pitch)];
    const rt = [Math.cos(yaw), 0, -Math.sin(yaw)];
    let m = false;
    if (keys['w']) { pos = pos.map((p,i) => p + fw[i]*sp); m = true; }
    if (keys['s']) { pos = pos.map((p,i) => p - fw[i]*sp); m = true; }
    if (keys['a']) { pos = pos.map((p,i) => p - rt[i]*sp); m = true; }
    if (keys['d']) { pos = pos.map((p,i) => p + rt[i]*sp); m = true; }
    if (keys['q']) { pos[1] -= sp; m = true; }
    if (keys['e']) { pos[1] += sp; m = true; }
    if (m) dirty = true;
  }
  if (pos && dirty && !busy) {
    busy = true; dirty = false;
    const t0 = performance.now();
    fetch(`/render?x=${pos[0]}&y=${pos[1]}&z=${pos[2]}&yaw=${yaw}&pitch=${pitch}`)
      .then(r => r.blob()).then(b => {
        img.src = URL.createObjectURL(b);
        document.getElementById('st').textContent =
          `${(performance.now()-t0).toFixed(0)} ms`;
        busy = false;
      }).catch(() => busy = false);
  }
  requestAnimationFrame(step);
}
step();
</script></body></html>"""


def _viewer_camera(size: int) -> Camera:
    return Camera(camera_id=0, width=size, height=size, fx=0.9 * size,
                  fy=0.9 * size, cx=size / 2, cy=size / 2)


def _cam_inputs(kf: Keyframe, device) -> dict:
    return {k: torch.as_tensor(v, device=device)
            for k, v in kf.render_inputs().items()}


def _pose_to_cam_inputs(pos, yaw, pitch, cam: Camera, device="cpu") -> dict:
    """Fly-control pose -> Keyframe render inputs, as tensors on
    `device`."""
    fw = np.array([
        np.sin(yaw) * np.cos(pitch), np.sin(pitch),
        np.cos(yaw) * np.cos(pitch),
    ])
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fw)
    right /= np.linalg.norm(right)
    up2 = np.cross(fw, right)
    R = np.stack([right, up2, fw], axis=0)  # world-to-camera
    q = se3.rotmat_to_quat(torch.as_tensor(R, dtype=torch.float32)).numpy()
    t = -R @ np.asarray(pos)
    return _cam_inputs(Keyframe(kf_id=0, camera=cam, quat=q, trans=t),
                       device)


def _on(device: torch.device):
    """The device made current for this thread (the HTTP server's threads
    start on card 0 otherwise)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _to_u8(img: torch.Tensor) -> np.ndarray:
    """(3, H, W) in [0, 1] -> (H, W, 3) uint8, as the JAX viewer quantises
    (truncation)."""
    img = img.cpu().numpy()
    return (np.clip(np.transpose(img, (1, 2, 0)), 0, 1) * 255).astype(
        np.uint8)


# the start view: 1.5 behind the active anchors' centroid along z, looking
# down +z
START_OFFSET = np.array([0.0, 0.0, -1.5])


def _centroid(anchors) -> np.ndarray | None:
    """The active anchors' centroid, or None without an active anchor."""
    active = anchors.active
    if not bool(active.any()):
        return None
    return anchors.anchor[active].mean(dim=0).cpu().numpy()


def build_renderer(args):
    """(render_pose(pos, yaw, pitch) -> (H, W, 3) uint8, start position,
    (w, h)) for the train state at args.ckpt, rendered on args.device with
    calibrate_eval_config's sizes, calibrated once on a view of the active
    anchors' centroid."""
    from segs_slam_tpu_torch.io.checkpoint import load_train_state
    from segs_slam_tpu_torch.ops.rasterizer import RasterConfig

    dev = torch.device(args.device)
    ts = load_train_state(args.ckpt, device=dev)
    cap = ts.anchors.anchor.shape[0]
    if cap != args.capacity:
        raise SystemExit(f"--capacity {args.capacity}: the checkpoint "
                         f"{args.ckpt} holds {cap} anchor slots")
    mc = dataclasses.replace(ts.decoders.config, capacity=cap)
    w = h = args.size
    cam = _viewer_camera(w)
    rc = RasterConfig(tile=16, compact=args.compact, kmax=args.kmax,
                      chunk=256, ksmall=args.ksmall,
                      nlarge=args.nlarge if args.ksmall else 0)
    center = _centroid(ts.anchors)
    if center is None:
        raise SystemExit(f"{args.ckpt}: no active anchor to view")
    kf0 = Keyframe(kf_id=0, camera=cam, quat=[1, 0, 0, 0],
                   trans=(-center).tolist())
    rc = calibrate_eval_config(rc, mc, ts.anchors, ts.decoders,
                               [_cam_inputs(kf0, dev)], w, h)
    renderer = EvalRenderer(mc, rc, w, h, torch.zeros(3), device=dev)
    lock = threading.Lock()

    def render_pose(pos, yaw, pitch):
        cam_in = _pose_to_cam_inputs(pos, yaw, pitch, cam, dev)
        with lock, _on(dev):  # one render at a time on the card
            return _to_u8(renderer(ts.anchors, ts.decoders, cam_in))

    return render_pose, (center + START_OFFSET).tolist(), (w, h)


def make_server(render_pose, start_pos_fn, w, h,
                port) -> ThreadingHTTPServer:
    """HTTP server over a render_pose(pos, yaw, pitch) -> (H, W, 3) uint8
    callable. start_pos_fn is called for each /state request (the live
    map's centroid moves as mapping grows). Port 0 binds a free port:
    `server_address[1]` names it."""
    from PIL import Image

    page = PAGE.replace("__W__", str(w)).replace("__H__", str(h))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(200, page.encode(), "text/html")
            elif u.path == "/state":
                self._send(200, json.dumps(
                    {"pos": start_pos_fn(), "yaw": 0.0}
                ).encode(), "application/json")
            elif u.path == "/render":
                q = parse_qs(u.query)

                def f(k, d=0.0):
                    return float(q.get(k, [d])[0])

                rgb = render_pose([f("x"), f("y"), f("z")], f("yaw"),
                                  f("pitch"))
                buf = io.BytesIO()
                Image.fromarray(rgb).save(buf, "JPEG", quality=90)
                self._send(200, buf.getvalue(), "image/jpeg")
            else:
                self._send(404, b"not found", "text/plain")

    return ThreadingHTTPServer(("0.0.0.0", port), Handler)


def serve_live(trainer, port=8600, size=480):
    """The live viewer: fly around the map while the mapper builds it (the
    renderFromPose equivalent, reference: src/gaussian_mapper.cpp:
    2484-2538, which renders from the running mapper under its render
    mutex). Each render holds `trainer.lock`, which the Trainer holds
    across each train iteration and map edit, so no render reads a
    half-updated or half-permuted map; that lock also keeps one render in
    flight at a time. Renders run on trainer.device with the trainer's
    model and raster configs, mid-grey until the trainer has initialised;
    the eval tier sizes are calibrated against the live map at the first
    request only.

    Returns the server's thread (a daemon), with the server as its
    `server` attribute: `th.server.server_address[1]` is the bound port
    (port 0 binds a free one), `th.server.shutdown()` stops it.
    """
    w = h = size
    cam = _viewer_camera(size)
    dev = torch.device(trainer.device)
    box: dict = {}
    errors: list = []

    def render_pose(pos, yaw, pitch):
        cam_in = _pose_to_cam_inputs(pos, yaw, pitch, cam, dev)
        try:
            with trainer.lock, _on(dev):
                st = trainer.state
                if st is None:
                    return np.full((h, w, 3), 64, np.uint8)
                if "renderer" not in box:
                    rc = calibrate_eval_config(
                        trainer.raster_config, trainer.model_config,
                        st.anchors, st.decoders, [cam_in], w, h)
                    box["renderer"] = EvalRenderer(
                        trainer.model_config, rc, w, h, torch.zeros(3),
                        device=dev)
                return _to_u8(box["renderer"](st.anchors, st.decoders,
                                              cam_in))
        except Exception as e:  # kept for the caller, then re-raised
            errors.append(e)
            raise

    def start_pos():
        with trainer.lock:
            st = trainer.state
            center = None if st is None else _centroid(st.anchors)
        return ([0.0, 0.0, -2.0] if center is None
                else (center + START_OFFSET).tolist())

    srv = make_server(render_pose, start_pos, w, h, port)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.server, th.errors = srv, errors
    th.start()
    print(f"[viewer] live viewer on http://localhost:"
          f"{srv.server_address[1]}/ ({w}x{h})", flush=True)
    return th


def parse_args(argv=None) -> argparse.Namespace:
    """The checkpoint viewer's flags (the JAX CLI's, plus --device)."""
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt", required=True)
    p.add_argument("--port", type=int, default=8600)
    p.add_argument("--size", type=int, default=480)
    p.add_argument("--capacity", type=int, default=2**14)
    p.add_argument("--compact", type=int, default=2**15)
    p.add_argument("--kmax", type=int, default=8)
    p.add_argument("--ksmall", type=int, default=4)
    p.add_argument("--nlarge", type=int, default=2**13)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    render_pose, start_pos, (w, h) = build_renderer(args)
    srv = make_server(render_pose, lambda: start_pos, w, h, args.port)
    print(f"viewer on http://localhost:{srv.server_address[1]}/ "
          f"({w}x{h}, ckpt {args.ckpt})", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
