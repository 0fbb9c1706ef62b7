"""segs_slam_tpu_torch: the PyTorch + CUDA port of segs_slam_tpu.

Same module layout and names as the JAX package, which stays in the
repository as the reference the port is tested against. Plain tensor code is
PyTorch; every Pallas kernel of the JAX package becomes a kernel written by
hand for Hopper (sources under csrc/, built on first use by ops/cuda_lib.py).
This package never imports JAX.
"""

__version__ = "0.1.0"
