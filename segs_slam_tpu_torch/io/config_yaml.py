"""Reader for the reference's gaussian-mapper YAML configs.

Accepts the exact files under the reference's cfg/gaussian_mapper/ tree
(OpenCV FileStorage flavor: a `%YAML:1.0` directive and flat `Group.key:
value` entries — reference: readConfigFromFile,
src/gaussian_mapper.cpp:224-521) and maps them onto this framework's config
dataclasses, so a user of the reference can reuse their tuned configs
unchanged.

Copy of segs_slam_tpu/io/config_yaml.py over the port's configs.
"""

from __future__ import annotations

from pathlib import Path

from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.slam.mapper import MapperConfig
from segs_slam_tpu_torch.train.config import OptimizationConfig


def parse_opencv_yaml(path: str | Path) -> dict:
    """Flat key -> value (int/float/str) parser for OpenCV-style YAML."""
    out: dict = {}
    for raw in Path(path).read_text().splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line or line.startswith("%") or line.startswith("---"):
            continue
        if ":" not in line:
            continue
        key, _, val = line.partition(":")
        key = key.strip()
        val = val.strip().strip('"')
        if not val:
            continue
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out


def load_mapper_yaml(path: str | Path, capacity: int = 2**16):
    """Returns (ModelConfig, OptimizationConfig, MapperConfig, extras)."""
    y = parse_opencv_yaml(path)

    def g(key, default):
        return y.get(key, default)

    model = ModelConfig(
        feat_dim=g("Model.feat_dim", 32),
        n_offsets=g("Model.n_offsets", 10),
        voxel_size=float(g("Model.voxel_size", 0.001)),
        update_depth=g("Model.update_depth", 3),
        update_init_factor=g("Model.update_init_factor", 16),
        update_hierachy_factor=g("Model.update_hierachy_factor", 4),
        use_feat_bank=bool(g("Model.use_feat_bank", 0)),
        appearance_dim=g("Model.appearance_dim", 32),
        ratio=g("Model.ratio", 1),
        add_opacity_dist=bool(g("Model.add_opacity_dist", 0)),
        add_cov_dist=bool(g("Model.add_cov_dist", 0)),
        add_color_dist=bool(g("Model.add_color_dist", 0)),
        embedding_dim=g("Model.embedding_dim", 179),
        capacity=capacity,
    )

    opt = OptimizationConfig(
        iterations=g("Optimization.max_num_iterations", 30_000),
        position_lr_init=float(g("Optimization.position_lr_init", 0.0)),
        position_lr_final=float(g("Optimization.position_lr_final", 0.0)),
        position_lr_delay_mult=float(g("Optimization.position_lr_delay_mult", 0.01)),
        position_lr_max_steps=g("Optimization.position_lr_max_steps", 30_000),
        offset_lr_init=float(g("Optimization.offset_lr_init", 0.07)),
        offset_lr_final=float(g("Optimization.offset_lr_final", 0.0001)),
        offset_lr_delay_mult=float(g("Optimization.offset_lr_delay_mult", 0.01)),
        offset_lr_max_steps=g("Optimization.offset_lr_max_steps", 30_000),
        feature_lr=float(g("Optimization.feature_lr", 0.0010)),
        opacity_lr=float(g("Optimization.opacity_lr", 0.02)),
        scaling_lr=float(g("Optimization.scaling_lr", 0.005)),
        rotation_lr=float(g("Optimization.rotation_lr", 0.001)),
        mlp_opacity_lr_init=float(g("Optimization.mlp_opacity_lr_init", 0.002)),
        mlp_opacity_lr_final=float(g("Optimization.mlp_opacity_lr_final", 0.00002)),
        mlp_opacity_lr_delay_mult=float(
            g("Optimization.mlp_opacity_lr_delay_mult", 0.01)
        ),
        mlp_opacity_lr_max_steps=g("Optimization.mlp_opacity_lr_max_steps", 30_000),
        mlp_cov_lr_init=float(g("Optimization.mlp_cov_lr_init", 0.004)),
        mlp_cov_lr_final=float(g("Optimization.mlp_cov_lr_final", 0.004)),
        mlp_cov_lr_delay_mult=float(g("Optimization.mlp_cov_lr_delay_mult", 0.01)),
        mlp_cov_lr_max_steps=g("Optimization.mlp_cov_lr_max_steps", 30_000),
        mlp_color_lr_init=float(g("Optimization.mlp_color_lr_init", 0.008)),
        mlp_color_lr_final=float(g("Optimization.mlp_color_lr_final", 0.00005)),
        mlp_color_lr_delay_mult=float(
            g("Optimization.mlp_color_lr_delay_mult", 0.01)
        ),
        mlp_color_lr_max_steps=g("Optimization.mlp_color_lr_max_steps", 30_000),
        mlp_featurebank_lr_init=float(
            g("Optimization.mlp_featurebank_lr_init", 0.01)
        ),
        mlp_featurebank_lr_final=float(
            g("Optimization.mlp_featurebank_lr_final", 0.00001)
        ),
        appearance_lr_init=float(g("Optimization.appearance_lr_init", 0.05)),
        appearance_lr_final=float(g("Optimization.appearance_lr_final", 0.0005)),
        percent_dense=float(g("Optimization.percent_dense", 0.01)),
        lambda_dssim=float(g("Optimization.lambda_dssim", 0.2)),
        start_stat=g("Optimization.start_stat", 500),
        update_from=g("Optimization.update_from", 1500),
        update_interval=g("Optimization.update_interval", 100),
        update_until=g("Optimization.update_until", 25_500),
        min_opacity=float(g("Optimization.min_opacity", 0.005)),
        success_threshold=float(g("Optimization.success_threshold", 0.8)),
        densify_grad_threshold=float(
            g("Optimization.densify_grad_threshold", 0.0002)
        ),
        use_frequency_regularization=bool(
            g("Mapper.use_frequency_regularization", 0)
        ),
        use_multi_resolution=bool(g("Mapper.use_multi_resolution", 0)),
        scale_num=g("Mapper.scale_num", 3),
        frequency_regulization_until=g("Mapper.frequency_regulization_until", 25_500),
        high_frequency_regularization_start=g(
            "Mapper.high_frequency_regularization_start", 5_000
        ),
        lambda_frequency_high=float(g("Mapper.lambda_frequency_high", 0.01)),
        lambda_frequency_low=float(g("Mapper.lambda_frequency_low", 0.0)),
    )

    mapper = MapperConfig(
        min_num_initial_map_kfs=g("Mapper.min_num_initial_map_kfs", 10),
        new_keyframe_times_of_use=g("Mapper.new_keyframe_times_of_use", 8),
        local_ba_increased_times_of_use=g(
            "Mapper.local_BA_increased_times_of_use", 0
        ),
        loop_closure_increased_times_of_use=g(
            "Mapper.loop_closure_increased_times_of_use_", 2
        ),
        cull_keyframes=bool(g("Mapper.cull_keyframes", 0)),
        inactive_geo_densify=bool(g("Mapper.inactive_geo_densify", 0)),
        depth_cache=g("Mapper.depth_cache", 10),
        min_depth=float(g("RGBD.min_depth", 1e-10)),
        max_depth=float(g("RGBD.max_depth", 40.0)),
    )

    extras = {
        "z_near": float(g("Camera.z_near", 0.01)),
        "z_far": float(g("Camera.z_far", 100.0)),
        "white_background": bool(g("Model.white_background", 0)),
        "gaus_pyramid_do": bool(g("GausPyramid.do", 0)),
        "gaus_pyramid_num_sub_levels": g("GausPyramid.num_sub_levels", 2),
        "gaus_pyramid_times_of_use": g("GausPyramid.sub_level_times_of_use", 8),
        "stereo_min_disparity": g("Stereo.min_disparity", 8),
        "stereo_num_disparity": g("Stereo.num_disparity", 128),
        "mono_max_pixel_dist": float(
            g("Monocular.inactive_geo_densify_max_pixel_dist", 20.0)
        ),
        "keyframe_record_interval": g("Record.keyframe_record_interval", 0),
        "all_keyframes_record_interval": g(
            "Record.all_keyframes_record_interval", 0
        ),
    }
    return model, opt, mapper, extras
