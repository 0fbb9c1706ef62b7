"""Trajectory and FPS metrics of the offline evaluation harness.

A copy of the numpy module segs_slam_tpu/eval/metrics.py (the port imports
nothing of the JAX package): Umeyama alignment, ATE, rotation APE,
`fps_from_times` and TUM trajectory I/O, replacing the reference's evo-based
computation (reference: eval/run.py:150-231).

`lpips_fn` builds LPIPS (eval/run.py:112-141; eval/lpips.py) from the
weights pickle SEGS_LPIPS_WEIGHTS names, and returns None without one, as
the JAX module does.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Least-squares similarity aligning src -> dst (Umeyama 1991).
    Returns (s, R, t) with dst ~= s * R @ src + t."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(
    est_positions: np.ndarray,  # (n, 3) estimated camera centers
    gt_positions: np.ndarray,  # (n, 3)
    correct_scale: bool = False,
) -> dict:
    """Absolute trajectory error (translation RMSE after alignment)."""
    s, R, t = umeyama_alignment(est_positions, gt_positions, correct_scale)
    aligned = (s * (R @ est_positions.T)).T + t
    err = np.linalg.norm(aligned - gt_positions, axis=1)
    return {
        "ate_rmse": float(np.sqrt((err**2).mean())),
        "ate_mean": float(err.mean()),
        "ate_median": float(np.median(err)),
        "scale": s,
        "aligned_est": aligned,
    }


def rotation_ape(
    est_rotations: np.ndarray,  # (n, 3, 3) world-to-camera
    gt_rotations: np.ndarray,
    est_positions: np.ndarray,
    gt_positions: np.ndarray,
    correct_scale: bool = False,
) -> dict:
    """Rotation-part APE in degrees after trajectory alignment
    (reference: eval/run.py pose_relation=rotation_angle_deg)."""
    _, R_align, _ = umeyama_alignment(est_positions, gt_positions, correct_scale)
    errs = []
    for Re, Rg in zip(est_rotations, gt_rotations):
        # camera-to-world rotations after alignment
        dR = Rg.T @ (Re @ R_align.T)
        cos = (np.trace(dR) - 1.0) / 2.0
        errs.append(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
    errs = np.array(errs)
    return {
        "rot_ape_rmse_deg": float(np.sqrt((errs**2).mean())),
        "rot_ape_mean_deg": float(errs.mean()),
    }


def fps_from_times(times_s: np.ndarray) -> float:
    """reference: eval/run.py:150-158 (1/mean for tracking seconds,
    1000/mean for render milliseconds — pass seconds here)."""
    times_s = np.asarray(times_s, float)
    if len(times_s) == 0 or times_s.mean() <= 0:
        return 0.0
    return float(1.0 / times_s.mean())


def load_tum_trajectory(path: str | Path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """TUM format: t tx ty tz qx qy qz qw (camera-to-world).
    Returns (times, positions (n,3), quats_wxyz (n,4))."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(x) for x in line.split()[:8]])
    arr = np.array(rows)
    times = arr[:, 0]
    pos = arr[:, 1:4]
    q_xyzw = arr[:, 4:8]
    q_wxyz = np.concatenate([q_xyzw[:, 3:4], q_xyzw[:, :3]], axis=1)
    return times, pos, q_wxyz


def save_tum_trajectory(path: str | Path, times, positions, quats_wxyz) -> None:
    """reference: System::SaveTrajectoryTUM / SaveKeyFrameTrajectoryTUM."""
    with open(path, "w") as f:
        for t, p, q in zip(times, positions, quats_wxyz):
            w, x, y, z = q
            f.write(
                f"{t:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} "
                f"{x:.7f} {y:.7f} {z:.7f} {w:.7f}\n"
            )


def lpips_fn(device="cuda"):
    """An lpips(img1, img2) callable on `device` (eval/lpips.py) with the
    weights of the pickle SEGS_LPIPS_WEIGHTS names, or None when the
    variable is unset or the file is missing."""
    weights = os.environ.get("SEGS_LPIPS_WEIGHTS", "")
    if not weights or not Path(weights).exists():
        return None
    import pickle

    from segs_slam_tpu_torch.eval.lpips import make_lpips
    from segs_slam_tpu_torch.io.convert import lpips_params_to_torch

    with open(weights, "rb") as f:
        params = pickle.load(f)
    return make_lpips(lpips_params_to_torch(params, device))
