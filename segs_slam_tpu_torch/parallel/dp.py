"""Data parallelism over keyframes on torch.distributed.

Port of segs_slam_tpu/parallel/dp.py. The reference is single-GPU
(SURVEY §2.4); the JAX package scales out with shard_map over a mesh: each
device renders one keyframe of a batch against a replicated map, the
gradients are averaged and the densify statistics summed across the mesh,
and every device computes the same Adam update. Here each rank of a
process group is one such device: it holds the whole state, renders its
own keyframe, and the step's collectives (train/step.py, `group`) make the
ranks' updates equal.

The body is the single-device step (make_train_step with `group`), so the
two cannot drift. Start the group yourself, for example

    torch.distributed.init_process_group(
        "gloo", init_method="file:///tmp/dp_init", world_size=2, rank=r)

(gloo all-reduces CPU and CUDA tensors; NCCL needs one card a rank), then
call the step on every rank with the same state and each rank's keyframe.
"""

from __future__ import annotations

from segs_slam_tpu_torch.models.config import ModelConfig
from segs_slam_tpu_torch.ops.rasterizer import RasterConfig
from segs_slam_tpu_torch.train.config import OptimizationConfig
from segs_slam_tpu_torch.train.step import make_train_step


def make_dp_train_step(group, model_config: ModelConfig,
                       opt_config: OptimizationConfig,
                       raster_config: RasterConfig, width: int, height: int):
    """This rank's data-parallel step: step(ts, cam, gt_image, bg,
    kf_row=None, gt_depth=None) -> (ts, metrics) over this rank's keyframe,
    with `ts` replicated across `group` (torch.distributed.group.WORLD for
    the default group) and updated in place identically on every rank.
    Metrics: loss, l1, psnr and ssim averaged over the ranks,
    num_instances, num_compact and num_kmax_truncated their largest,
    nonfinite_grads summed."""
    if group is None:
        raise ValueError("make_dp_train_step needs a process group "
                         "(torch.distributed.group.WORLD for the default)")
    return make_train_step(model_config, opt_config, raster_config, width,
                           height, group=group)
