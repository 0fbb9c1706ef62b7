"""Offline evaluation harness, the onekey.py / run.py equivalent.

A copy of segs_slam_tpu/eval/harness.py over the port's metrics: walks
result directories (the recorder's layout, which matches the reference's),
computes ATE from trajectory files and tracking / render FPS, and aggregates
everything into log.txt / log.csv (reference: eval/onekey.py:19-120,
eval/run.py:84-246). LPIPS is not ported yet (eval/metrics.py:lpips_fn).
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from segs_slam_tpu_torch.eval import metrics as M


def _read_floats(path: Path) -> np.ndarray:
    if not path.exists():
        return np.array([])
    return np.array(
        [float(x) for x in path.read_text().split() if x.strip()], float
    )


def evaluate_run(run_dir: str | Path, mono: bool = False) -> dict:
    run_dir = Path(run_dir)
    out: dict = {"run": str(run_dir)}

    render_ms = _read_floats(run_dir / "render_time.txt")
    if len(render_ms):
        out["render_fps"] = 1000.0 / render_ms.mean()
    tracking_s = _read_floats(run_dir / "TrackingTime.txt")
    if len(tracking_s):
        out["tracking_fps"] = M.fps_from_times(tracking_s)
    for name, key in [
        ("psnr.txt", "psnr"),
        ("dssim.txt", "dssim"),
        ("psnr_gaussian_splatting.txt", "psnr_gs"),
    ]:
        vals = _read_floats(run_dir / name)
        if len(vals):
            out[key] = float(vals.mean())

    # LPIPS over rendered vs ground_truth dirs (reference: run.py:112-141):
    # lpips_fn raises where it is asked for, so here it is always skipped,
    # and the column is absent, not silently zero
    if M.lpips_fn() is None:
        print(f"[eval] {run_dir}: LPIPS skipped (not ported; "
              "SEGS_LPIPS_WEIGHTS is unset)", flush=True)
        out["lpips_skipped"] = 1.0

    # ATE: estimated vs ground-truth trajectories in TUM format
    est_p = run_dir / "CameraTrajectory_TUM.txt"
    gt_p = run_dir / "groundtruth.txt"
    if est_p.exists() and gt_p.exists():
        _, est_pos, est_q = M.load_tum_trajectory(est_p)
        _, gt_pos, gt_q = M.load_tum_trajectory(gt_p)
        n = min(len(est_pos), len(gt_pos))
        out.update(M.ate_rmse(est_pos[:n], gt_pos[:n], correct_scale=mono))

    return out


def aggregate(results_root: str | Path, mono: bool = False,
              log_name: str = "log") -> list[dict]:
    """onekey: evaluate every run directory under results_root and write
    log.txt + log.csv (reference: eval/onekey.py:96-120)."""
    results_root = Path(results_root)
    runs = sorted(
        d for d in results_root.iterdir() if (d / "psnr.txt").exists()
    ) if results_root.is_dir() else []
    rows = [evaluate_run(d, mono=mono) for d in runs]
    if not rows:
        return rows

    keys = sorted({k for r in rows for k in r if k != "run"})
    with open(results_root / f"{log_name}.txt", "w") as f:
        for r in rows:
            f.write(r["run"] + "\n")
            for k in keys:
                if k in r:
                    f.write(f"  {k}: {r[k]:.4f}\n")
        means = {
            k: np.mean([r[k] for r in rows if k in r])
            for k in keys
            if any(k in r for r in rows)
        }
        f.write("MEAN\n")
        for k, v in means.items():
            f.write(f"  {k}: {v:.4f}\n")
    with open(results_root / f"{log_name}.csv", "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=["run"] + keys)
        wr.writeheader()
        for r in rows:
            wr.writerow(r)
    return rows
