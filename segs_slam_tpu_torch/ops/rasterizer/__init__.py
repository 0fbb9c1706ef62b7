from segs_slam_tpu_torch.ops.rasterizer.preprocess import (
    RasterConfig,
    compute_cov3d,
    preprocess_gaussians,
)
from segs_slam_tpu_torch.ops.rasterizer.rasterize import (
    rasterize,
    visible_filter,
)

__all__ = [
    "RasterConfig",
    "compute_cov3d",
    "preprocess_gaussians",
    "rasterize",
    "visible_filter",
]
