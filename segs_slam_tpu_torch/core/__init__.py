from segs_slam_tpu_torch.core import se3
from segs_slam_tpu_torch.core.camera import (
    Camera,
    focal2fov,
    fov2focal,
    projection_matrix,
    world_to_view,
)
from segs_slam_tpu_torch.core.keyframe import Keyframe

__all__ = [
    "Camera",
    "Keyframe",
    "focal2fov",
    "fov2focal",
    "projection_matrix",
    "world_to_view",
    "se3",
]
