"""Shared CLI config resolution for the online SLAM apps.

Port of segs_slam_tpu/apps/common.py: the flags and the reference-YAML
ingest path, so that the SLAM apps consume the reference's own
cfg/gaussian_mapper/<Sensor>/<Dataset>/*.yaml operating points (reference
ingest: readConfigFromFile, src/gaussian_mapper.cpp:224-521), with the
dual-rate rasterizer and undistortion plumbing. Two flags are refused until
their parts are ported: --viewer-port (the live viewer) and a non-zero
--kanchor (the eval path's per-anchor pre-compaction).
"""

from __future__ import annotations

import dataclasses

from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from segs_slam_tpu_torch.slam.mapper import MapperConfig
from segs_slam_tpu_torch.train.config import OptimizationConfig

# Per-dataset radial-tangential distortion (k1 k2 p1 p2 k3) defaults
# (reference: cfg/ORB_SLAM3/RGB-D/TUM/tum_freiburg1_desk.yaml Camera1.k1...;
# Replica/ScanNet exports are pre-undistorted).
DATASET_DIST_COEFFS = {
    "tum": (0.262383, -0.953104, -0.005358, 0.002628, 1.163314),  # fr1
    "replica": (0.0, 0.0, 0.0, 0.0, 0.0),
    "scannet": (0.0, 0.0, 0.0, 0.0, 0.0),
}


def add_common_args(p, default_compact=2**16, default_kmax=8):
    p.add_argument("--mapper-yaml", default="",
                   help="reference gaussian-mapper YAML "
                        "(cfg/gaussian_mapper/...); drives model/optimization"
                        "/mapper/pyramid settings like the reference ingest")
    p.add_argument("--capacity", type=int, default=2**16)
    p.add_argument("--compact", type=int, default=default_compact)
    p.add_argument("--kmax", type=int, default=default_kmax)
    # Dual-rate instance expansion (binning.py): every gaussian gets ksmall
    # tile slots, only the nlarge largest-footprint ones get up to kmax.
    # 0 disables (full [compact, kmax] grid).
    p.add_argument("--ksmall", type=int, default=4)
    p.add_argument("--nlarge", type=int, default=2**13)
    p.add_argument("--undistort", choices=["auto", "on", "off"],
                   default="auto",
                   help="radtan undistortion of input images (auto = on "
                        "when the dataset preset carries coefficients)")
    p.add_argument("--dist-coeffs", type=float, nargs=5, default=None,
                   metavar=("K1", "K2", "P1", "P2", "K3"),
                   help="override distortion coefficients")
    p.add_argument("--packed-train", choices=["auto", "on", "off"],
                   default="auto",
                   help="packed (f16-pair) binning sorts on the training "
                        "path (auto = on when kmax <= 31 and compact <= "
                        "2^16; the blend still takes the f32 binning where "
                        "the grid is wider than 63 tiles: "
                        "blend.py:uses_packed_train)")
    p.add_argument("--model-set", action="append", default=[],
                   help="ModelConfig field override, e.g. "
                        "--model-set appearance_dim=0 (ablations)")
    p.add_argument("--kanchor", type=int, default=0,
                   help="per-anchor K-axis pre-compaction on the eval "
                        "render path; not ported: only 0 is accepted")
    p.add_argument("--opt-set", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="override an OptimizationConfig field (repeatable), "
                        "e.g. --opt-set pose_prior=0.005; applied after the "
                        "YAML ingest")
    p.add_argument("--viewer-port", type=int, default=0,
                   help="the live web viewer's port (0 = off); the viewer "
                        "is not ported yet, so only 0 is accepted")


def check_unported(args) -> None:
    """Refuse the flags whose parts the port does not have yet."""
    if getattr(args, "viewer_port", 0):
        raise SystemExit("--viewer-port: the live viewer is not ported yet "
                         "(segs_slam_tpu/apps/viewer.py)")
    if getattr(args, "kanchor", 0):
        raise SystemExit("--kanchor: the kanchor pre-compaction is not "
                         "ported")


def resolve_dist_coeffs(args, dataset: str):
    """Distortion coefficients for the run, or None when disabled/zero."""
    if args.undistort == "off":
        return None
    coeffs = (tuple(args.dist_coeffs) if args.dist_coeffs is not None
              else DATASET_DIST_COEFFS.get(dataset, (0.0,) * 5))
    if not any(coeffs):
        return None
    return coeffs


def _override(cfg, key: str, raw: str, flag: str, kind: str):
    if not hasattr(cfg, key):
        raise SystemExit(f"{flag}: {kind} has no field {key!r}")
    cur = getattr(cfg, key)
    val = (raw.lower() in ("1", "true", "yes") if isinstance(cur, bool)
           else type(cur)(raw))
    return dataclasses.replace(cfg, **{key: val})


def resolve_configs(args, iters_budget: int, mapper_overrides: dict | None
                    = None):
    """(ModelConfig, OptimizationConfig, MapperConfig, RasterConfig,
    trainer_kwargs) from the CLI and an optional reference YAML.

    The YAML (when given) is authoritative for model/optimization/mapper
    keys; explicit CLI values override iters/capacity; mapper_overrides
    (e.g. pose_refine_every from app flags) override the YAML mapper keys.
    """
    check_unported(args)
    trainer_kwargs: dict = {}
    if args.mapper_yaml:
        from segs_slam_tpu_torch.io.config_yaml import load_mapper_yaml

        mc, oc, mpc, extras = load_mapper_yaml(args.mapper_yaml,
                                               capacity=args.capacity)
        if iters_budget:
            oc = dataclasses.replace(oc, iterations=iters_budget)
        # GausPyramid.* -> Trainer coarse-to-fine supervision
        # (reference: src/gaussian_mapper.cpp:837-859)
        if extras.get("gaus_pyramid_do"):
            trainer_kwargs["num_pyramid_sub_levels"] = extras[
                "gaus_pyramid_num_sub_levels"]
            trainer_kwargs["pyramid_times_of_use"] = extras[
                "gaus_pyramid_times_of_use"]
        trainer_kwargs["white_background"] = extras.get(
            "white_background", False)
        trainer_kwargs["keyframe_times_of_use"] = (
            mpc.new_keyframe_times_of_use)
    else:
        mc = ModelConfig(capacity=args.capacity)
        oc = OptimizationConfig(iterations=iters_budget)
        mpc = MapperConfig()
    if mapper_overrides:
        mpc = dataclasses.replace(mpc, **mapper_overrides)
    for kv in getattr(args, "opt_set", []):
        key, _, raw = kv.partition("=")
        oc = _override(oc, key, raw, "--opt-set", "OptimizationConfig")
    for kv in getattr(args, "model_set", []):
        key, _, raw = kv.partition("=")
        mc = _override(mc, key, raw, "--model-set", "ModelConfig")
    # the image size may not be known yet here, so "auto" gates on the
    # static constraints only; the blend takes the f32 binning itself where
    # the grid is wider (blend.py:uses_packed_train)
    packed = (args.packed_train == "on"
              or (args.packed_train == "auto" and args.kmax <= 31
                  and args.compact <= 2**16))
    rc = RasterConfig(tile=16, compact=args.compact, kmax=args.kmax,
                      chunk=256, ksmall=args.ksmall,
                      nlarge=args.nlarge if args.ksmall else 0,
                      packed_train=packed)
    return mc, oc, mpc, rc, trainer_kwargs
