from segs_slam_tpu_torch.native.bindings import (
    NativeLoader,
    NativeTracker,
    library_path,
    native_available,
)

__all__ = ["NativeLoader", "NativeTracker", "library_path",
           "native_available"]
