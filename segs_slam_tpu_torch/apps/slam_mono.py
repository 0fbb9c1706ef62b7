"""Online monocular SLAM + mapping, the replica_mono / tum_mono /
scannet_mono equivalent.

Port of segs_slam_tpu/apps/slam_mono.py (entry-point skeleton of the
reference's examples/replica_mono.cpp / tum_mono.cpp): frames -> the native
mono tracker (two-view bootstrap + persistent map + windowed BA,
native/tracker.cpp) -> MappingOperation queue with keyframe payloads
carrying keypoint pixels + camera-local 3D (the GetKeypointInfo tuple of
the reference protocol, ORB-SLAM3/src/KeyFrame.cc:1172-1199) -> Mapper with
monocular inactive-geometry densification, training on the card (kernels K1
and K2 in every step) -> shutdown artifacts (keyframe renders through K3).

Map scale is arbitrary (the tracker normalises the bootstrap map to a
median depth); evaluation aligns trajectories with a scale-corrected
Umeyama fit, as the reference's `--correct_scale` mono evaluation does
(reference: eval/run.py:166-231). An <path>/imu.txt, where present, makes
it mono-inertial: the tracker preintegrates it and refines the metric scale
online, and the app forwards each refinement as a SCALE_REFINEMENT op.

    python -m segs_slam_tpu_torch.apps.slam_mono --dataset replica \
        --path <seq> --out results/mono_run [--iters-budget N] \
        [--device cuda]
"""

from __future__ import annotations

import argparse
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
from segs_slam_tpu_torch.apps.slam_rgbd import DATASET_DEFAULTS
from segs_slam_tpu_torch.core.camera import Camera
from segs_slam_tpu_torch.eval import metrics as M
from segs_slam_tpu_torch.eval.recorder import record_all_keyframes
from segs_slam_tpu_torch.io import datasets
from segs_slam_tpu_torch.io.checkpoint import (
    save_cameras_json,
    save_mlp_checkpoints_txt,
)
from segs_slam_tpu_torch.native import NativeTracker
from segs_slam_tpu_torch.slam.mapper import Mapper
from segs_slam_tpu_torch.slam.producers import (
    ScaleDriftMonitor,
    tracker_pose_updates,
)
from segs_slam_tpu_torch.slam.protocol import (
    KeyframeData,
    MappingOperation,
    MappingQueue,
    OperationKind,
)
from segs_slam_tpu_torch.train.trainer import Trainer
from segs_slam_tpu_torch.utils.make_imu import load_imu_txt, quat_to_R


def run_mono_producer(frames, camera, queue, tracking_times, stop_event,
                      fps=0.0, imu=None, data_fps=30.0):
    """Tracking thread: mono track + keyframe ops with keypoint payloads
    (numpy and the native library only; no device work). Returns one
    (timestamp, quat, trans) row per frame fed to the tracker."""
    tracker = NativeTracker(camera.fx, camera.fy, camera.cx, camera.cy)
    next_pid = [0]
    fed_frames: list[int] = []
    est_rows = []

    def _pose_updates(frame_nos, poses7):
        return tracker_pose_updates(fed_frames, frame_nos, poses7)

    # live mono scale refinement: when the tracker's BA drifts the map scale
    # relative to what the mapper ingested, emit SCALE_REFINEMENT instead of
    # letting the map absorb it photometrically (the reference's path is
    # IMU-only, LocalMapping.cc:1296-1305; this extends it to pure mono)
    drift = ScaleDriftMonitor()

    frame_interval = (1.0 / fps) if fps else 0.0
    for i, fr in enumerate(frames):
        if stop_event.is_set():
            break
        if frame_interval:
            time.sleep(frame_interval)
        rgb = fr.load_rgb()
        gray = (rgb.mean(axis=2) * 255).astype(np.uint8)
        fed_frames.append(i)
        if imu is not None:
            # mono-inertial: the tracker preintegrates these into its motion
            # prior and the online scale/gravity initialisation
            imu_times, imu_gyro, imu_accel, imu_cursor = imu
            t_frame = i / data_fps
            dt_s = (imu_times[1] - imu_times[0]) if len(imu_times) > 1 else 0.0
            while (imu_cursor[0] < len(imu_times)
                   and imu_times[imu_cursor[0]] < t_frame - 1e-9):
                k = imu_cursor[0]
                tracker.feed_imu(dt_s, imu_gyro[k], imu_accel[k])
                imu_cursor[0] += 1
        t0 = time.perf_counter()
        status, pose7, n_inl = tracker.track_mono(gray)
        tracking_times.append(time.perf_counter() - t0)
        quat, trans = pose7[3:7], pose7[0:3]
        est_rows.append((fr.timestamp, quat.copy(), trans.copy()))
        # mono-inertial metric scale refinement (the tracker already rescaled
        # its internal map; forward the factor + the rescaled trajectory so
        # that the gaussian map and cached points follow; reference:
        # ORB-SLAM3/src/LocalMapping.cc:1296-1305 pushing ScaleRefinement)
        s_imu = tracker.poll_scale() if imu is not None else 0.0
        if s_imu:
            _, tr_fnos, tr_poses = tracker.trajectory()
            sop = MappingOperation(kind=OperationKind.SCALE_REFINEMENT)
            sop.scale = s_imu
            sop.transform = None
            sop.pose_updates = _pose_updates(tr_fnos, tr_poses)
            queue.push(sop)
            drift.rebase(s_imu)
            print(f"[mono] IMU scale refinement at frame {i}: s={s_imu:.4f}",
                  flush=True)
        if status != 1:
            continue
        kp = tracker.keyframe_points()
        kfd = KeyframeData(
            kf_id=i, camera_id=camera.camera_id, quat=quat, trans=trans,
            image=rgb, depth=None, timestamp=fr.timestamp,
            keypoint_pixels=kp[:, :2] if len(kp) else None,
            keypoint_points=kp[:, 2:5] if len(kp) else None,
        )
        op = MappingOperation(kind=OperationKind.LOCAL_MAPPING_BA,
                              keyframes=[kfd])
        _, fnos, poses = tracker.window_poses()
        op.pose_updates = _pose_updates(fnos, poses)
        # scale-drift check against the full trajectory (windowed BA + loop
        # corrections can rescale history the mapper has already built on)
        _, tr_fnos, tr_poses = tracker.trajectory()
        traj_updates = _pose_updates(tr_fnos, tr_poses)
        hit = drift.check(traj_updates)
        if hit is not None:
            s, T = hit
            sop = MappingOperation(kind=OperationKind.SCALE_REFINEMENT)
            sop.scale = s
            sop.transform = T
            sop.pose_updates = traj_updates
            queue.push(sop)
            print(f"[mono] scale refinement at frame {i}: s={s:.4f}",
                  flush=True)
        drift.record(i, quat, trans)
        if len(kp):
            # camera-local 3D -> world for the sparse seed cloud
            R = quat_to_R(quat)
            pts_w = (R.T @ (kp[:, 2:5].T - trans[:, None])).T
            op.points_xyz = pts_w.astype(np.float32)
            op.point_ids = np.arange(next_pid[0], next_pid[0] + len(pts_w))
            next_pid[0] += len(pts_w)
        queue.push(op)

    # final-trajectory rewrite (reference: src/gaussian_mapper.cpp:684-761)
    _, fnos, poses = tracker.trajectory()
    op = MappingOperation(kind=OperationKind.LOCAL_MAPPING_BA)
    op.pose_updates = _pose_updates(fnos, poses)
    queue.push(op)
    final = {fed_frames[f]: p for f, p in zip(fnos, poses)
             if 0 <= f < len(fed_frames)}
    for j, (ts, q, t) in enumerate(est_rows):
        fi = fed_frames[j] if j < len(fed_frames) else None
        if fi in final:
            p = final[fi]
            est_rows[j] = (ts, p[3:7].copy(), p[0:3].copy())
    return est_rows


def main(argv=None) -> dict:
    """Runs the app; returns the record_all_keyframes aggregates (with
    `ate_rmse_scaled` and `ate_scale`, the similarity-aligned ATE and its
    scale) plus `iterations`, `mapping_s` (host clock around Mapper.run to
    a synchronised device), `ms_per_iter` and `trainer`."""
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", choices=["replica", "tum", "scannet"],
                   required=True)
    p.add_argument("--path", required=True)
    p.add_argument("--out", default="results/mono_run")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--iters-budget", type=int, default=30_000)
    add_common_args(p)
    p.add_argument("--fps", type=float, default=0.0)
    p.add_argument("--min-init-kfs", type=int, default=5)
    p.add_argument("--no-imu", action="store_true",
                   help="ignore <path>/imu.txt (pure-mono ablation)")
    p.add_argument("--fx", type=float, default=0)
    p.add_argument("--fy", type=float, default=0)
    p.add_argument("--cx", type=float, default=-1)
    p.add_argument("--cy", type=float, default=-1)
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    d = dict(DATASET_DEFAULTS[args.dataset])
    for k, v in (("w", args.width), ("h", args.height), ("fx", args.fx),
                 ("fy", args.fy)):
        if v:
            d[k] = v
    if args.cx >= 0:
        d["cx"] = args.cx
    if args.cy >= 0:
        d["cy"] = args.cy
    cam = Camera(camera_id=0, width=d["w"], height=d["h"], fx=d["fx"],
                 fy=d["fy"], cx=d["cx"], cy=d["cy"])

    if args.dataset == "replica":
        frames = datasets.load_replica(args.path)
    elif args.dataset == "scannet":
        frames = datasets.load_scannet(args.path)
    else:
        frames = datasets.load_tum_rgbd(args.path)
    if args.max_frames:
        frames = frames[: args.max_frames]
    print(f"{len(frames)} frames (mono)")

    mc, oc, mpc, rc, trainer_kwargs = resolve_configs(
        args, args.iters_budget,
        mapper_overrides=dict(min_num_initial_map_kfs=args.min_init_kfs,
                              inactive_geo_densify=True,
                              # mono scale: bound the densify band to the
                              # tracker's normalised map depth, not meters
                              min_depth=0.05, max_depth=20.0),
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

    # optional inertial stream: <path>/imu.txt rows `t gx gy gz ax ay az`
    # (written by utils/make_rgbd_dataset --imu). Mono-inertial: the tracker
    # preintegrates for motion priors and online metric-scale refinement
    # (reference: ORB-SLAM3/src/LocalMapping.cc:1296-1305 ScaleRefinement).
    imu = None
    imu_path = Path(args.path) / "imu.txt"
    if imu_path.exists() and not args.no_imu:
        ts_imu, gy, ac = load_imu_txt(imu_path)
        imu = (ts_imu, gy, ac, [0])
        print(f"IMU stream: {len(ts_imu)} samples from {imu_path}")

    def producer():
        try:
            est_rows.extend(run_mono_producer(
                frames, cam, queue, tracking_times, stop_event,
                fps=args.fps, imu=imu))
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
    ate = None
    if est_rows:
        centers = [-quat_to_R(q).T @ t for _, q, t in est_rows]
        M.save_tum_trajectory(out / "CameraTrajectory_TUM.txt",
                              [r[0] for r in est_rows], centers,
                              [q for _, q, _ in est_rows])
        gt_centers = [-quat_to_R(f.quat).T @ np.asarray(f.trans)
                      for f in frames]
        M.save_tum_trajectory(out / "groundtruth.txt",
                              [f.timestamp for f in frames], gt_centers,
                              [f.quat for f in frames])
        n = min(len(centers), len(gt_centers))
        ate = M.ate_rmse(np.stack(centers[:n]), np.stack(gt_centers[:n]),
                         correct_scale=True)
        print(f"mono ATE (scale-corrected): {ate['ate_rmse']:.4f} "
              f"(scale {ate['scale']:.3f})")

    agg = record_all_keyframes(trainer, out, tracking_times=tracking_times,
                               total_runtime_s=runtime)
    if ate is not None:
        agg["ate_rmse_scaled"] = ate["ate_rmse"]
        agg["ate_scale"] = ate["scale"]
    trainer.save_ply(out / "anchors.ply")
    save_mlp_checkpoints_txt(out / "mlps", trainer.state.decoders)
    save_cameras_json(out / "cameras.json", trainer.scene.keyframes)
    print("done:", {k: round(float(v), 3) for k, v in agg.items()},
          f"runtime {runtime:.0f}s, {trainer.iteration} iters")
    return dict(agg, iterations=trainer.iteration, mapping_s=mapping_s,
                ms_per_iter=1000.0 * mapping_s / max(trainer.iteration, 1),
                trainer=trainer, viewer=viewer)


if __name__ == "__main__":
    main()
