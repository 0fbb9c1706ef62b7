"""Online RGB-D SLAM + mapping, the replica_rgbd / tum_rgbd equivalent.

Port of segs_slam_tpu/apps/slam_rgbd.py (entry-point skeleton of the
reference's examples/tum_rgbd.cpp:119-268): a producer thread (dataset
loader, undistortion, tracking by the native ORB+PnP tracker or the
ground-truth pose oracle) pushes MappingOperations into the queue; the
Mapper trains the map on the main thread, on the card (kernels K1 and K2 in
every step, through the packed training binning where
RasterConfig.packed_train allows it); at shutdown the trajectories, the
keyframe renders and metrics (K3), the PLY, the MLP text dumps and
cameras.json are written.

    python -m segs_slam_tpu_torch.apps.slam_rgbd --dataset replica \
        --path <seq_dir> --out results/replica_room0 \
        [--tracker native|oracle] [--iters-budget N] [--device cuda]

With --tracker native (the default) frames load through the native
library's threaded loader (native/bindings.py, built on first use) and an
<path>/imu.txt, where present, feeds the tracker's preintegration; with
--tracker oracle they load through PIL (and core/undistort.py where the
dataset carries distortion). --viewer-port serves the live viewer
(apps/viewer.py) while the mapper runs; the result's "viewer" is its
thread.
"""

from __future__ import annotations

import argparse
import os
import threading
import time
from pathlib import Path

import numpy as np
import torch

from segs_slam_tpu_torch.apps.common import (
    add_common_args,
    maybe_start_live_viewer,
    resolve_configs,
    resolve_dist_coeffs,
)
from segs_slam_tpu_torch.core.camera import Camera
from segs_slam_tpu_torch.eval import metrics as M
from segs_slam_tpu_torch.eval.recorder import (
    record_all_frames,
    record_all_keyframes,
)
from segs_slam_tpu_torch.io import datasets
from segs_slam_tpu_torch.io.checkpoint import (
    save_cameras_json,
    save_mlp_checkpoints_txt,
)
from segs_slam_tpu_torch.native import NativeLoader, NativeTracker
from segs_slam_tpu_torch.slam import frontends
from segs_slam_tpu_torch.slam.mapper import Mapper
from segs_slam_tpu_torch.slam.producers import tracker_pose_updates
from segs_slam_tpu_torch.slam.protocol import (
    KeyframeData,
    MappingOperation,
    MappingQueue,
    OperationKind,
)
from segs_slam_tpu_torch.train.trainer import Trainer
from segs_slam_tpu_torch.utils.make_imu import load_imu_txt

# Per-dataset camera intrinsics defaults (reference: cfg/ORB_SLAM3 yamls)
DATASET_DEFAULTS = {
    "replica": dict(fx=600.0, fy=600.0, cx=599.5, cy=339.5, w=1200, h=680,
                    depth_scale=6553.5),
    "tum": dict(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
                w=640, h=480, depth_scale=5000.0),
    # ScanNet exports per-scene intrinsics (intrinsic/intrinsic_color.txt),
    # read at load time; these are scene0000-style fallbacks.
    "scannet": dict(fx=1169.62, fy=1167.11, cx=646.295, cy=489.927,
                    w=1296, h=968, depth_scale=1000.0),
}


def _rotmat(q) -> np.ndarray:
    w_, x_, y_, z_ = q
    return np.array([
        [1 - 2 * (y_ * y_ + z_ * z_), 2 * (x_ * y_ - w_ * z_),
         2 * (x_ * z_ + w_ * y_)],
        [2 * (x_ * y_ + w_ * z_), 1 - 2 * (x_ * x_ + z_ * z_),
         2 * (y_ * z_ - w_ * x_)],
        [2 * (x_ * z_ - w_ * y_), 2 * (y_ * z_ + w_ * x_),
         1 - 2 * (x_ * x_ + y_ * y_)],
    ])


def run_producer(frames, camera, queue, tracker_kind, depth_scale,
                 keyframe_every, points_per_kf, tracking_times, stop_event,
                 fps=0.0, dist_coeffs=None, imu=None, data_fps=30.0):
    """Tracking thread: decode + undistort + track + push keyframe ops
    (numpy and the native library only; no device work). Returns one
    (timestamp, quat, trans) row per frame, the estimated trajectory.

    With --tracker native, frames decode in the native loader's worker pool
    and go through the native ORB+PnP tracker: each keyframe carries its
    keypoints and the post-BA window poses, a loop closure pushes a
    LOOP_CLOSING_BA op with the whole corrected trajectory, and at shutdown
    every keyframe adopts its final pose. With the pose oracle, frames load
    through PIL and the dataset's ground truth is the pose.

    With `dist_coeffs`, images are undistorted before anything sees them
    (reference: Camera::initUndistortRectifyMapAndMask,
    include/camera.h:76-113): in the native loader, or by
    core.undistort.UndistortMap with the oracle. Out-of-map border pixels
    come back black, which the photometric losses mask."""
    rng = np.random.default_rng(0)
    next_pid = [0]
    tracker = None
    if tracker_kind == "native":
        tracker = NativeTracker(camera.fx, camera.fy, camera.cx, camera.cy)

    fed_frames: list[int] = []  # tracker frame_no -> dataset frame index

    def _tracker_pose_updates(frame_nos, poses7):
        return tracker_pose_updates(fed_frames, frame_nos, poses7)

    def push_keyframe(i, fr, rgb, depth, quat, trans, kp=None,
                      pose_updates=None):
        kfd = KeyframeData(
            kf_id=i, camera_id=camera.camera_id, quat=quat, trans=trans,
            image=rgb, depth=depth, timestamp=fr.timestamp,
            keypoint_pixels=kp[:, :2] if kp is not None else None,
            keypoint_points=kp[:, 2:5] if kp is not None else None,
        )
        op = MappingOperation(kind=OperationKind.LOCAL_MAPPING_BA,
                              keyframes=[kfd])
        if pose_updates:
            op.pose_updates = pose_updates
        if depth is not None:
            pts = frontends.backproject_depth(depth, camera, quat, trans,
                                              0.05, 20.0, stride=8)
            if len(pts) > points_per_kf:
                pts = pts[rng.choice(len(pts), points_per_kf, replace=False)]
            op.points_xyz = pts
            op.point_ids = np.arange(next_pid[0], next_pid[0] + len(pts))
            next_pid[0] += len(pts)
        queue.push(op)

    if tracker is not None:
        loader = NativeLoader(
            [f.rgb_path for f in frames], [f.depth_path for f in frames],
            depth_scale=depth_scale, n_threads=4, dist_coeffs=dist_coeffs,
            intrinsics=(camera.fx, camera.fy, camera.cx, camera.cy))
        frame_iter = iter(loader)
    else:
        umap = None
        if dist_coeffs is not None:
            import dataclasses

            from segs_slam_tpu_torch.core.undistort import UndistortMap

            umap = UndistortMap(dataclasses.replace(
                camera, dist_coeffs=tuple(dist_coeffs)))

        def _frames():
            for i, f in enumerate(frames):
                rgb = f.load_rgb()
                depth = f.load_depth(depth_scale)
                if umap is not None:
                    rgb = umap.remap(rgb)
                    if depth is not None:
                        depth = umap.remap(depth)
                yield i, rgb, depth
        frame_iter = _frames()

    est_rows = []
    frame_interval = (1.0 / fps) if fps else 0.0
    for i, rgb, depth in frame_iter:
        if stop_event.is_set():
            break
        if frame_interval:
            time.sleep(frame_interval)
        fr = frames[i]
        t0 = time.perf_counter()
        pose_updates = None
        loop_cand = -1
        if tracker is not None and imu is not None:
            # feed IMU samples up to this frame's timestamp; the tracker
            # preintegrates them into the motion prior (reference:
            # ORB-SLAM3 Tracking.cc PreintegrateIMU / PredictStateIMU)
            imu_times, imu_gyro, imu_accel, imu_cursor = imu
            t_frame = i / data_fps
            dt_s = (imu_times[1] - imu_times[0]) if len(imu_times) > 1 else 0.0
            while (imu_cursor[0] < len(imu_times)
                   and imu_times[imu_cursor[0]] < t_frame - 1e-9):
                k = imu_cursor[0]
                tracker.feed_imu(dt_s, imu_gyro[k], imu_accel[k])
                imu_cursor[0] += 1
        if tracker is not None and depth is not None:
            fed_frames.append(i)
            gray = (rgb.mean(axis=2) * 255).astype(np.uint8)
            if os.environ.get("SG_ABL_FORCE_GT"):
                # diagnostic ablation: run the full tracker (keyframe
                # selection, BA, timing) but pin its output poses to ground
                # truth, which isolates pose-error-driven mapping loss
                tracker.set_gt_hint(np.concatenate([fr.trans, fr.quat]))
            status, pose7, _ = tracker.track(gray, depth)
            quat = pose7[3:7]
            trans = pose7[0:3]
            if os.environ.get("SG_ABL_FORCE_GT"):
                quat, trans = fr.quat.copy(), np.asarray(fr.trans).copy()
            is_kf = status == 1
            if is_kf:
                kp = tracker.keyframe_points()
                # post-BA window poses -> LOCAL_MAPPING_BA pose refreshes
                # (reference: LocalMapping.cc:149-160)
                _, fnos, poses = tracker.window_poses()
                pose_updates = _tracker_pose_updates(fnos, poses)
                if os.environ.get("SG_ABL_NO_POSE_UPDATES"):
                    # diagnostic: isolate the refresh stream's times-of-use
                    # and delta-reset side effects
                    pose_updates = None
                loop_cand = tracker.poll_loop()
            else:
                kp = None
        else:  # pose oracle from the dataset ground truth
            quat, trans = np.asarray(fr.quat), np.asarray(fr.trans)
            is_kf = i % keyframe_every == 0
            kp = None
        tracking_times.append(time.perf_counter() - t0)
        # carry the dataset frame index so that the final-trajectory rewrite
        # keys rows by frame id: est_rows gets a row for every frame, while
        # fed_frames grows only on the tracker's branch
        est_rows.append((i, fr.timestamp, np.asarray(quat).copy(),
                         np.asarray(trans).copy()))
        if is_kf:
            push_keyframe(i, fr, rgb, depth, np.asarray(quat),
                          np.asarray(trans), kp, pose_updates)
        if loop_cand >= 0:
            # the trajectory was rigidly corrected: refresh every keyframe
            # pose (reference: LoopClosing.cc:1201 pushes LoopClosingBA)
            _, fnos, poses = tracker.trajectory()
            op = MappingOperation(kind=OperationKind.LOOP_CLOSING_BA)
            op.pose_updates = _tracker_pose_updates(fnos, poses)
            queue.push(op)
            print(f"[tracker] loop closure at frame {i} "
                  f"(candidate kf {loop_cand}), "
                  f"{len(op.pose_updates)} poses corrected", flush=True)

    if tracker is not None:
        # final-trajectory pose rewrite at shutdown: every mapped keyframe
        # adopts its final optimised pose before the tail optimisation
        # (reference: src/gaussian_mapper.cpp:684-761)
        _, fnos, poses = tracker.trajectory()
        op = MappingOperation(kind=OperationKind.LOCAL_MAPPING_BA)
        op.pose_updates = _tracker_pose_updates(fnos, poses)
        queue.push(op)
        # keyframe rows take their final poses, keyed by dataset frame index
        # (not by position; see est_rows)
        final = {fed_frames[f]: p for f, p in zip(fnos, poses)
                 if 0 <= f < len(fed_frames)}
        for j, (fi, ts, q, t) in enumerate(est_rows):
            if fi in final:
                p = final[fi]
                est_rows[j] = (fi, ts, p[3:7].copy(), p[0:3].copy())
    return [(ts, q, t) for _, ts, q, t in est_rows]


def _save_trajectories(out: Path, est_rows, frames) -> None:
    """CameraTrajectory_TUM.txt (the estimate) and groundtruth.txt, camera
    centres and world-to-camera quaternions in TUM format."""
    M.save_tum_trajectory(
        out / "CameraTrajectory_TUM.txt", [r[0] for r in est_rows],
        [-_rotmat(q).T @ t for _, q, t in est_rows],
        [np.asarray(q) for _, q, _ in est_rows])
    M.save_tum_trajectory(
        out / "groundtruth.txt", [f.timestamp for f in frames],
        [-_rotmat(f.quat).T @ f.trans for f in frames],
        [f.quat for f in frames])


def main(argv=None) -> dict:
    """Runs the app; returns the record_all_keyframes aggregates plus
    `iterations`, `mapping_s` (host clock around Mapper.run to a
    synchronised device), `ms_per_iter`, `folded` (pose rows folded at
    shutdown) and `trainer` (the Trainer, for callers that go on with the
    map)."""
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", choices=["replica", "tum", "scannet"],
                   required=True)
    p.add_argument("--path", required=True)
    p.add_argument("--out", default="results/run")
    p.add_argument("--tracker", choices=["native", "oracle"],
                   default="native")
    p.add_argument("--keyframe-every", type=int, default=10)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--iters-budget", type=int, default=30_000)
    add_common_args(p)
    p.add_argument("--downscale", type=int, default=1)
    p.add_argument("--fps", type=float, default=0.0,
                   help="pace the frame feed (0 = free-run)")
    p.add_argument("--min-init-kfs", type=int, default=10)
    p.add_argument("--debug-ckpt-at", type=int, default=0,
                   help="save the train state to <out>/debug_ckpt.pt after "
                        "this iteration (0 = never)")
    p.add_argument("--pose-refine-on-arrival", type=int, default=0,
                   help="photometric frame-to-model alignment steps for "
                        "each new keyframe against the current map (0 = "
                        "off)")
    p.add_argument("--pose-refine-every", type=int, default=0,
                   help="photometric keyframe-pose refinement cadence "
                        "(0 = off)")
    p.add_argument("--shutdown-pose-refine", type=int, default=0,
                   help="rounds of shutdown pose refinement: after the "
                        "training budget, re-estimate every keyframe pose "
                        "against the converged map, then re-fit the map "
                        "(0 = off)")
    p.add_argument("--shutdown-pose-refine-iters", type=int, default=400,
                   help="re-fit train iterations per shutdown-refine round")
    p.add_argument("--optimize-poses", choices=["auto", "on", "off"],
                   default="auto",
                   help="in-step photometric pose optimization (per-keyframe "
                        "SE3 deltas trained with the map); auto = off, as "
                        "in the JAX app")
    p.add_argument("--all-frames-eval", action="store_true",
                   help="post-run novel-view eval over every tracked frame "
                        "(reference: renderAndRecordAllframes)")
    p.add_argument("--all-frames-images", action="store_true",
                   help="also dump strided renders/GT pngs for the "
                        "all-frames eval")
    # intrinsic overrides (e.g. synthetic datasets)
    p.add_argument("--fx", type=float, default=0)
    p.add_argument("--fy", type=float, default=0)
    p.add_argument("--cx", type=float, default=-1)
    p.add_argument("--cy", type=float, default=-1)
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    d = dict(DATASET_DEFAULTS[args.dataset])
    if args.dataset == "scannet":
        intr = datasets.load_scannet_intrinsics(args.path)
        if intr:
            d.update(intr)
        # the intrinsic export carries no image size; it is calibrated for
        # the exported colour resolution, so adopt the first frame's size
        probe_frames = datasets.load_scannet(args.path)
        if probe_frames:
            ph, pw = probe_frames[0].load_rgb().shape[:2]
            d["w"], d["h"] = pw, ph
    for key, val in (("w", args.width), ("h", args.height),
                     ("fx", args.fx), ("fy", args.fy)):
        if val:
            d[key] = val
    if args.cx >= 0:
        d["cx"] = args.cx
    if args.cy >= 0:
        d["cy"] = args.cy
    s = args.downscale
    cam = Camera(camera_id=0, width=d["w"] // s, height=d["h"] // s,
                 fx=d["fx"] / s, fy=d["fy"] / s,
                 cx=d["cx"] / s, cy=d["cy"] / s)

    if args.dataset == "replica":
        frames = datasets.load_replica(args.path)
    elif args.dataset == "scannet":
        frames = datasets.load_scannet(args.path)
    else:
        frames = datasets.load_tum_rgbd(args.path)
    if args.max_frames:
        frames = frames[: args.max_frames]
    print(f"{len(frames)} frames")
    if frames:
        probe = frames[0].load_rgb()
        if probe.shape[:2] != (cam.height, cam.width):
            raise SystemExit(
                f"dataset images are {probe.shape[1]}x{probe.shape[0]} but "
                f"the camera is configured {cam.width}x{cam.height} (the "
                f"'{args.dataset}' preset). Pass --width/--height/--fx/--fy/"
                f"--cx/--cy to match the dataset.")

    mc, oc, mpc, rc, trainer_kwargs = resolve_configs(
        args, args.iters_budget,
        mapper_overrides=dict(
            min_num_initial_map_kfs=args.min_init_kfs,
            pose_refine_every=args.pose_refine_every,
            pose_refine_on_arrival=args.pose_refine_on_arrival,
            shutdown_pose_refine_rounds=args.shutdown_pose_refine,
            shutdown_pose_refine_iters=args.shutdown_pose_refine_iters),
    )
    # "auto" is off, as in the JAX app: in-step joint pose optimisation
    # random-walks the per-keyframe deltas (segs_slam_tpu/apps/
    # slam_rgbd.py:350-353); --pose-refine-every is the supported path
    if args.optimize_poses == "on":
        trainer_kwargs["optimize_poses"] = True
    dev = torch.device(args.device)
    trainer = Trainer(mc, oc, rc, width=cam.width, height=cam.height,
                      device=dev, **trainer_kwargs)
    trainer.scene.add_camera(cam)
    queue = MappingQueue()
    mapper = Mapper(queue, trainer, cam, mpc)
    viewer = maybe_start_live_viewer(args, trainer)
    out = Path(args.out)
    mapper.debug_ckpt_at = args.debug_ckpt_at
    mapper.debug_ckpt_path = out / "debug_ckpt.pt"
    dist_coeffs = resolve_dist_coeffs(args, args.dataset)
    if dist_coeffs is not None:
        print(f"undistortion on: k={dist_coeffs}")

    tracking_times: list[float] = []
    stop_event = threading.Event()
    est_rows: list = []

    # optional inertial stream: <path>/imu.txt rows `t gx gy gz ax ay az`
    # (written by utils/make_rgbd_dataset --imu; EuRoC-convention units),
    # fed to the native tracker's preintegration between frames
    imu = None
    imu_path = Path(args.path) / "imu.txt"
    if args.tracker == "native" and imu_path.exists():
        ts_imu, gy, ac = load_imu_txt(imu_path)
        imu = (ts_imu, gy, ac, [0])
        print(f"IMU stream: {len(ts_imu)} samples from {imu_path}")

    def producer():
        try:
            est_rows.extend(run_producer(
                frames, cam, queue, args.tracker, d["depth_scale"],
                args.keyframe_every, 300, tracking_times, stop_event,
                fps=args.fps, dist_coeffs=dist_coeffs, imu=imu))
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
    nfold = trainer.fold_pose_deltas()
    if nfold:
        print(f"folded in-step pose deltas into {nfold} keyframes")

    out.mkdir(parents=True, exist_ok=True)
    if est_rows:
        _save_trajectories(out, est_rows, frames)
    agg = record_all_keyframes(trainer, out, tracking_times=tracking_times,
                               total_runtime_s=runtime)
    if args.all_frames_eval and est_rows:
        af = record_all_frames(trainer, out, frames,
                               [(q, t) for _, q, t in est_rows], cam,
                               record_images=args.all_frames_images)
        print("all-frames eval:", {k: round(v, 3) for k, v in af.items()})
    trainer.save_ply(out / "anchors.ply")
    save_mlp_checkpoints_txt(out / "mlps", trainer.state.decoders)
    save_cameras_json(out / "cameras.json", trainer.scene.keyframes)
    print("done:", {k: round(v, 3) for k, v in agg.items()},
          f"runtime {runtime:.0f}s, {trainer.iteration} iters, mapping "
          f"{mapping_s:.1f}s")
    return dict(agg, iterations=trainer.iteration, mapping_s=mapping_s,
                ms_per_iter=1000.0 * mapping_s / max(trainer.iteration, 1),
                folded=nfold, trainer=trainer, viewer=viewer)


if __name__ == "__main__":
    main()
