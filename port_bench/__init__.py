"""The benchmark of segs_slam_tpu_torch on an NVIDIA H100 (see README.md)."""
