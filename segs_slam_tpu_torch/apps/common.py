"""Shared CLI config resolution for the online SLAM apps.

Port of segs_slam_tpu/apps/common.py: the flags and the reference-YAML
ingest path, so that the SLAM apps consume the reference's own
cfg/gaussian_mapper/<Sensor>/<Dataset>/*.yaml operating points (reference
ingest: readConfigFromFile, src/gaussian_mapper.cpp:224-521), with the
dual-rate rasterizer and undistortion plumbing, --kanchor (the eval path's
per-anchor pre-compaction) and the live viewer (--viewer-port,
`maybe_start_live_viewer`).
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
                        "RasterConfig.train_binning)")
    p.add_argument("--model-set", action="append", default=[],
                   help="ModelConfig field override, e.g. "
                        "--model-set appearance_dim=0 (ablations)")
    p.add_argument("--kanchor", type=int, default=0,
                   help="per-anchor K-axis pre-compaction on the EVAL "
                        "render path (see RasterConfig.kanchor); 0 = off")
    p.add_argument("--opt-set", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="override an OptimizationConfig field (repeatable), "
                        "e.g. --opt-set pose_prior=0.005; applied after the "
                        "YAML ingest")
    p.add_argument("--viewer-port", type=int, default=0,
                   help="serve the LIVE free-view web viewer from the "
                        "running mapper on this port (0 = off): the "
                        "renderFromPose equivalent, reference: "
                        "src/gaussian_mapper.cpp:2484-2538")


def maybe_start_live_viewer(args, trainer):
    """Start the live web viewer's thread when --viewer-port is set; the
    thread (apps/viewer.py:serve_live), or None."""
    if getattr(args, "viewer_port", 0):
        from segs_slam_tpu_torch.apps.viewer import serve_live

        return serve_live(trainer, port=args.viewer_port)
    return None


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


def raster_config(args, kgroup: int, packed_train: str) -> RasterConfig:
    """RasterConfig from --compact, --kmax, --ksmall, --nlarge, --kanchor
    (0 where an app has none) and packed_train "on", "off" or "auto" (on
    where the packed training binning takes the config on one tile; the
    blend takes the f32 one on grids it does not fit). `--compact 0 --kmax
    0` is the exact binning: no tiers, packing or pre-compaction."""
    exact = args.compact == 0 and args.kmax == 0
    ksmall = 0 if exact else args.ksmall
    kanchor = 0 if exact else getattr(args, "kanchor", 0)
    rc = RasterConfig(tile=16, compact=args.compact, kmax=args.kmax,
                      chunk=256, ksmall=ksmall,
                      nlarge=args.nlarge if ksmall else 0, kanchor=kanchor,
                      kgroup=kgroup if kanchor else 0)
    if exact or packed_train == "off":
        return rc
    packed = dataclasses.replace(rc, packed_train=True)
    if packed_train == "on" or packed.train_binning(1, 1) == "packed":
        return packed
    return rc


def resolve_configs(args, iters_budget: int, mapper_overrides: dict | None
                    = None):
    """(ModelConfig, OptimizationConfig, MapperConfig, RasterConfig,
    trainer_kwargs) from the CLI and an optional reference YAML.

    The YAML (when given) is authoritative for model/optimization/mapper
    keys; explicit CLI values override iters/capacity; mapper_overrides
    (e.g. pose_refine_every from app flags) override the YAML mapper keys.
    """
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
    rc = raster_config(args, mc.n_offsets, args.packed_train)
    return mc, oc, mpc, rc, trainer_kwargs
