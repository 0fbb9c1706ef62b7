"""Synthetic IMU derivation from a camera trajectory.

Given world-to-camera poses at frame times, derives body-frame (= camera
frame; identity IMU-camera extrinsic) gyro/accel samples at a higher rate,
such that preintegrating the samples reproduces the frame-to-frame relative
motion up to integration error — the ground-truth contract the tracker's
IMU preintegration is tested against.

Reference analogue: the EuRoC stereo-inertial / RGB-D-inertial entry points
consume (t, gx, gy, gz, ax, ay, az) rows; ORB-SLAM3 preintegrates them
between frames (ORB-SLAM3/src/ImuTypes.cc IntegrateNewMeasurement). This
module is the data side; the tracker implements the preintegration side.

Model:
  * rotation: piecewise-constant body angular velocity per frame interval
    (exact slerp derivative), so exp(w*dt) chains reproduce frame rotations
    exactly.
  * position: cubic Hermite spline through camera centers with Catmull-Rom
    tangents -> piecewise-linear world acceleration.
  * accelerometer measures specific force f_b = R_bw (a_w - g_w) with
    g_w = (0, +9.81, 0) (world +y is down in the synthetic room).
  * optional white noise + constant biases.

Copy of segs_slam_tpu/utils/make_imu.py (numpy only).
"""

from __future__ import annotations

import numpy as np

GRAVITY_W = np.array([0.0, 9.81, 0.0])  # +y down in the synthetic room


def quat_to_R(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def log_so3(R):
    """Rotation vector of R (3x3)."""
    tr = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(tr)
    if th < 1e-10:
        return np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]]) * 0.5
    return (th / (2.0 * np.sin(th))) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])


def exp_so3(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-10:
        return np.eye(3) + K
    return (np.eye(3) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th**2 * (K @ K))


def derive_imu(poses, cam_fps: float = 30.0, imu_rate: float = 200.0,
               gyro_noise: float = 0.0, accel_noise: float = 0.0,
               gyro_bias=(0.0, 0.0, 0.0), accel_bias=(0.0, 0.0, 0.0),
               seed: int = 0, gravity_w=GRAVITY_W):
    """poses: list of (quat wxyz, trans) world-to-camera at frame times.

    Returns (times, gyro[N,3], accel[N,3]) body-frame samples covering
    [0, (n_frames-1)/cam_fps). Sample i covers the interval
    [times[i], times[i] + 1/imu_rate) (left-sampled, zero-order hold), so a
    consumer integrating `x += f(sample_i) * dt` reproduces the knots.
    """
    rng = np.random.default_rng(seed)
    n = len(poses)
    dt_f = 1.0 / cam_fps
    Rs = [quat_to_R(np.asarray(q, float)) for q, _ in poses]  # world->cam
    centers = np.stack([-R.T @ np.asarray(t, float) for R, (q, t) in
                        zip(Rs, poses)])

    # Per-interval constant body angular velocity under the standard
    # right-multiplication convention R_wb(t+dt) = R_wb(t) exp([w dt]):
    #   exp([w dt]) = R_wb_i^{-1} R_wb_{i+1} = R_i @ R_{i+1}^T
    # (R_wb = R^T for world-to-camera R). Round-trip verified in
    # tests/test_imu.py.
    w_int = np.zeros((n - 1, 3))
    for i in range(n - 1):
        w_int[i] = log_so3(Rs[i] @ Rs[i + 1].T) / dt_f

    # Catmull-Rom tangents -> cubic Hermite per interval
    vel = np.zeros((n, 3))
    vel[1:-1] = (centers[2:] - centers[:-2]) / (2 * dt_f)
    vel[0] = (centers[1] - centers[0]) / dt_f
    vel[-1] = (centers[-1] - centers[-2]) / dt_f

    sub = max(1, int(round(imu_rate / cam_fps)))
    dt_s = dt_f / sub
    times, gyro, accel = [], [], []
    gb = np.asarray(gyro_bias, float)
    ab = np.asarray(accel_bias, float)
    for i in range(n - 1):
        p0, p1 = centers[i], centers[i + 1]
        v0, v1 = vel[i], vel[i + 1]
        # Hermite basis second derivative at s in [0,1]:
        # p(s) = h00 p0 + h10 v0 dt + h01 p1 + h11 v1 dt
        for j in range(sub):
            t = i * dt_f + j * dt_s
            s = (j + 0.5) / sub  # midpoint sample of the ZOH interval
            a_w = ((12 * s - 6) * (p0 - p1) / dt_f**2
                   + (6 * s - 4) * v0 / dt_f + (6 * s - 2) * v1 / dt_f)
            # body rotation at s: R_wb(t) = R_wb(t_i) exp([w] s dt_f)
            R_wb = Rs[i].T @ exp_so3(w_int[i] * s * dt_f)
            f_b = R_wb.T @ (a_w - gravity_w)
            g_meas = w_int[i] + gb + rng.normal(0, gyro_noise, 3)
            a_meas = f_b + ab + rng.normal(0, accel_noise, 3)
            times.append(t)
            gyro.append(g_meas)
            accel.append(a_meas)
    return (np.asarray(times), np.stack(gyro).astype(np.float64),
            np.stack(accel).astype(np.float64))


def write_imu_txt(path, times, gyro, accel):
    """EuRoC-style rows: t[s] gx gy gz [rad/s] ax ay az [m/s^2]."""
    rows = [
        " ".join(f"{v:.9f}" for v in (t, *g, *a))
        for t, g, a in zip(times, gyro, accel)
    ]
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def load_imu_txt(path):
    arr = np.loadtxt(path)
    if arr.ndim == 1:
        arr = arr[None]
    return arr[:, 0], arr[:, 1:4], arr[:, 4:7]
