"""Online stereo SLAM + mapping, the euroc_stereo example equivalent.

Port of segs_slam_tpu/apps/slam_stereo.py (entry point:
examples/euroc_stereo.cpp): load the EuRoC pair stream, rectify both eyes
(numpy Bouguet maps, core/undistort.py), track (pose oracle from the ground
truth, or the native ORB+PnP tracker's rectified-stereo mode), densify
inactive geometry from stereo disparity (reference: src/gaussian_mapper.cpp
stereo SGM + reprojectImageTo3D path), and drive the same Mapper/Trainer as
the RGB-D app, on the card (kernels K1 and K2 in every step, K3 in the
keyframe evaluation).

    python -m segs_slam_tpu_torch.apps.slam_stereo --path <euroc_seq> \
        --out results/euroc_mh01 [--tracker oracle|native] [--downscale 2] \
        [--pre-rectified] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from pathlib import Path

import numpy as np
import torch

from segs_slam_tpu_torch.apps.common import (
    add_common_args,
    maybe_start_live_viewer,
    resolve_configs,
)
from segs_slam_tpu_torch.core import se3
from segs_slam_tpu_torch.core.camera import Camera
from segs_slam_tpu_torch.core.undistort import StereoRectifyMap
from segs_slam_tpu_torch.eval import metrics as M
from segs_slam_tpu_torch.eval.recorder import record_all_keyframes
from segs_slam_tpu_torch.io import datasets
from segs_slam_tpu_torch.native import NativeTracker
from segs_slam_tpu_torch.slam import frontends
from segs_slam_tpu_torch.slam.mapper import Mapper
from segs_slam_tpu_torch.slam.protocol import (
    KeyframeData,
    MappingOperation,
    MappingQueue,
    OperationKind,
)
from segs_slam_tpu_torch.train.trainer import Trainer

# EuRoC MAV cam0/cam1 calibration (mav0/cam*/sensor.yaml; the same constants
# the reference ships in its EuRoC ORB-SLAM3 yaml).
EUROC_CAM0 = dict(
    w=752, h=480, fx=458.654, fy=457.296, cx=367.215, cy=248.375,
    dist=(-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0),
)
EUROC_CAM1 = dict(
    w=752, h=480, fx=457.587, fy=456.134, cx=379.999, cy=255.238,
    dist=(-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0),
)
EUROC_T_BS0 = np.array([
    [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
    [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
    [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
    [0.0, 0.0, 0.0, 1.0],
])
EUROC_T_BS1 = np.array([
    [0.0125552670891, -0.999755099723, 0.0182237714554, -0.0198435579556],
    [0.999598781151, 0.0130119051815, 0.0251588363115, 0.0453689425024],
    [-0.0253898008918, 0.0179005838253, 0.999517347078, 0.00786212447038],
    [0.0, 0.0, 0.0, 1.0],
])


class PreRectified:
    """Identity 'rectifier' for datasets whose pairs are already rectified
    and distortion-free (e.g. utils/make_stereo_dataset.py)."""

    def __init__(self, camera: Camera, baseline: float):
        self.camera = camera
        self.baseline = baseline

    def remap_left(self, img):
        return img

    def remap_right(self, img):
        return img

    def rectify_pose(self, q, t):
        return np.asarray(q, np.float32), np.asarray(t, np.float32)


def build_rectifier(downscale: int = 1) -> StereoRectifyMap:
    camL = Camera(camera_id=0, width=EUROC_CAM0["w"], height=EUROC_CAM0["h"],
                  fx=EUROC_CAM0["fx"], fy=EUROC_CAM0["fy"],
                  cx=EUROC_CAM0["cx"], cy=EUROC_CAM0["cy"],
                  dist_coeffs=EUROC_CAM0["dist"])
    camR = Camera(camera_id=1, width=EUROC_CAM1["w"], height=EUROC_CAM1["h"],
                  fx=EUROC_CAM1["fx"], fy=EUROC_CAM1["fy"],
                  cx=EUROC_CAM1["cx"], cy=EUROC_CAM1["cy"],
                  dist_coeffs=EUROC_CAM1["dist"])
    T_10 = np.linalg.inv(EUROC_T_BS1) @ EUROC_T_BS0  # cam0 -> cam1
    return StereoRectifyMap(camL, camR, T_10[:3, :3], T_10[:3, 3],
                            scale=downscale)


def _disp_range(cam: Camera, baseline: float, max_depth: float,
                min_depth: float = 0.25) -> tuple[int, int]:
    """Disparity search window covering [min_depth, max_depth]: a fixed
    min_disparity of 8 caps the depth at fx*b/8 (about 3.1 m on EuRoC at
    half resolution), which gives all far geometry wrong near depths."""
    lo = max(1, int(np.floor(cam.fx * baseline / max_depth)))
    hi = int(np.ceil(cam.fx * baseline / min_depth))
    return lo, min(max(hi - lo, 16), 160)


def _depth_from_disparity(gray_l, gray_r, cam: Camera, baseline: float,
                          max_depth: float = 40.0) -> np.ndarray:
    """Full-resolution pseudo-depth: strided block matching upsampled
    nearest-neighbour (0 = invalid)."""
    min_disp, num_disp = _disp_range(cam, baseline, max_depth)
    disp, ys, xs = frontends.stereo_block_matching(
        gray_l, gray_r, min_disparity=min_disp, num_disparities=num_disp,
        stride=4,
    )
    depth_s = np.where(disp > 0, cam.fx * baseline / np.maximum(disp, 1e-6),
                       0.0)
    # scatter back to full resolution, then dilate by the stride so that
    # keypoint depth lookups hit a value
    full = np.zeros_like(gray_l, np.float32)
    yy = np.repeat(ys, len(xs))
    xx = np.tile(xs, len(ys))
    full[yy, xx] = depth_s.ravel()
    from numpy.lib.stride_tricks import sliding_window_view

    pad = 2
    padded = np.pad(full, pad, mode="constant")
    win = sliding_window_view(padded, (2 * pad + 1, 2 * pad + 1))
    return win.max(axis=(2, 3))


def run_stereo_producer(pairs, rectifier: StereoRectifyMap, queue,
                        tracker_kind, keyframe_every, points_per_kf,
                        tracking_times, stop_event, max_depth=40.0):
    """Tracking thread: rectify, track, densify from disparity and push
    keyframe ops (numpy and the native library only; no device work).
    Returns one (timestamp, quat, trans) row per tracked pair."""
    cam = rectifier.camera
    rng = np.random.default_rng(0)
    next_pid = [0]
    est_rows = []

    tracker = None
    if tracker_kind == "native":
        tracker = NativeTracker(cam.fx, cam.fy, cam.cx, cam.cy)

    for i, (fr, right_path) in enumerate(pairs):
        if stop_event.is_set():
            break
        if right_path is None:
            continue
        gray_l = rectifier.remap_left(
            datasets._imread(fr.rgb_path, grayscale=True)
        ).astype(np.float32)
        gray_r = rectifier.remap_right(
            datasets._imread(right_path, grayscale=True)
        ).astype(np.float32)
        t0 = time.perf_counter()
        if tracker is not None:
            # native stereo tracking (tracker.cpp sg_tracker_track_stereo):
            # left-right ORB row matching gives per-feature metric depth
            # inside the tracker; no host-side pseudo-depth needed
            status, pose7, _ = tracker.track_stereo(
                (gray_l * 255).astype(np.uint8),
                (gray_r * 255).astype(np.uint8), rectifier.baseline
            )
            quat, trans = pose7[3:7], pose7[0:3]
            is_kf = status == 1
        else:
            quat, trans = rectifier.rectify_pose(fr.quat, fr.trans)
            is_kf = i % keyframe_every == 0
        tracking_times.append(time.perf_counter() - t0)
        est_rows.append((fr.timestamp, np.asarray(quat).copy(),
                         np.asarray(trans).copy()))
        if not is_kf:
            continue
        rgb = np.repeat(gray_l[:, :, None], 3, axis=2)
        kfd = KeyframeData(kf_id=i, camera_id=cam.camera_id,
                           quat=np.asarray(quat), trans=np.asarray(trans),
                           image=rgb, depth=None, timestamp=fr.timestamp)
        op = MappingOperation(kind=OperationKind.LOCAL_MAPPING_BA,
                              keyframes=[kfd])
        min_disp, num_disp = _disp_range(cam, rectifier.baseline, max_depth)
        pts = frontends.stereo_densify(
            gray_l, gray_r, cam, rectifier.baseline, quat, trans,
            min_disparity=min_disp, num_disparities=num_disp,
            max_depth=max_depth,
        )
        if len(pts) > points_per_kf:
            pts = pts[rng.choice(len(pts), points_per_kf, replace=False)]
        if len(pts):
            op.points_xyz = pts
            op.point_ids = np.arange(next_pid[0], next_pid[0] + len(pts))
            next_pid[0] += len(pts)
        queue.push(op)
    return est_rows


def main(argv=None) -> dict:
    """Runs the app; returns the record_all_keyframes aggregates plus
    `iterations`, `mapping_s` (host clock around Mapper.run to a
    synchronised device), `ms_per_iter` and `trainer`."""
    p = argparse.ArgumentParser()
    p.add_argument("--path", required=True,
                   help="EuRoC sequence dir (contains mav0/)")
    p.add_argument("--out", default="results/stereo_run")
    p.add_argument("--tracker", choices=["native", "oracle"],
                   default="oracle")
    p.add_argument("--keyframe-every", type=int, default=10)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--frame-stride", type=int, default=1)
    p.add_argument("--iters-budget", type=int, default=30_000)
    add_common_args(p, default_kmax=16)
    p.add_argument("--downscale", type=int, default=2)
    p.add_argument("--min-init-kfs", type=int, default=10)
    p.add_argument("--pre-rectified", action="store_true",
                   help="dataset pairs are rectified + distortion-free; "
                        "intrinsics come from <path>/calib.json")
    p.add_argument("--max-depth", type=float, default=40.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    pairs = datasets.load_euroc_stereo(args.path)
    if args.frame_stride > 1:
        pairs = pairs[::args.frame_stride]
    if args.max_frames:
        pairs = pairs[: args.max_frames]
    print(f"{len(pairs)} stereo pairs")

    if args.pre_rectified:
        calib = json.loads((Path(args.path) / "calib.json").read_text())
        rect_cam = Camera(
            camera_id=0, width=calib["width"], height=calib["height"],
            fx=calib["fx"], fy=calib["fy"], cx=calib["cx"], cy=calib["cy"],
        )
        rectifier = PreRectified(rect_cam, calib["baseline"])
    else:
        rectifier = build_rectifier(args.downscale)
    cam = rectifier.camera

    mc, oc, mpc, rc, trainer_kwargs = resolve_configs(
        args, args.iters_budget,
        mapper_overrides=dict(min_num_initial_map_kfs=args.min_init_kfs),
    )
    dev = torch.device(args.device)
    trainer = Trainer(mc, oc, rc, width=cam.width, height=cam.height,
                      device=dev, **trainer_kwargs)
    trainer.scene.add_camera(cam)
    queue = MappingQueue()
    mapper = Mapper(queue, trainer, cam, mpc)
    viewer = maybe_start_live_viewer(args, trainer)

    tracking_times: list[float] = []
    stop_event = threading.Event()
    est_rows: list = []

    def producer():
        try:
            est_rows.extend(run_stereo_producer(
                pairs, rectifier, queue, args.tracker, args.keyframe_every,
                400, tracking_times, stop_event, max_depth=args.max_depth))
        finally:
            mapper.signal_stop()

    t0 = time.time()
    prod_thread = threading.Thread(target=producer, daemon=True)
    prod_thread.start()
    try:
        t_map = time.perf_counter()
        mapper.run(max_iterations=args.iters_budget)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        mapping_s = time.perf_counter() - t_map
    finally:
        stop_event.set()
        prod_thread.join()
    runtime = time.time() - t0

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if est_rows:
        centers = []
        for _, q, t in est_rows:
            # in f32, as the JAX app converts it
            R = se3.quat_to_rotmat(
                torch.as_tensor(np.asarray(q, np.float32))).numpy()
            centers.append(-R.T @ t)
        M.save_tum_trajectory(out / "CameraTrajectory_TUM.txt",
                              [r[0] for r in est_rows], centers,
                              [q for _, q, _ in est_rows])

    agg = record_all_keyframes(trainer, out, tracking_times=tracking_times,
                               total_runtime_s=runtime)
    trainer.save_ply(out / "anchors.ply")
    print("done:", {k: round(v, 3) for k, v in agg.items()},
          f"runtime {runtime:.0f}s, {trainer.iteration} iters")
    return dict(agg, iterations=trainer.iteration, mapping_s=mapping_s,
                ms_per_iter=1000.0 * mapping_s / max(trainer.iteration, 1),
                trainer=trainer, viewer=viewer)


if __name__ == "__main__":
    main()
