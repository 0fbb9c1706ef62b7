"""LPIPS (AlexNet variant), with weights the user supplies.

Port of segs_slam_tpu/eval/lpips_jax.py, itself the architecture of
lpipsPyTorch (reference: lpipsPyTorch/modules/: AlexNet features at 5
stages, unit-normalised, 1x1 linear heads, spatial mean). No pretrained
weights ship with the repository: the user exports them once to a pickle
of numpy arrays (SEGS_LPIPS_WEIGHTS; eval/metrics.py:lpips_fn):

  {"conv1_w": (64,3,11,11), "conv1_b": (64,), ... "conv5_w", "conv5_b",
   "lin0".."lin4": (C,) per-channel weights, "shift": (3,), "scale": (3,)}

The convolutions run in full f32 (no TF32, which cuDNN allows by default on
Hopper), so the card agrees with the CPU and with the JAX version.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

# (name, stride, padding, 3x3/2 max-pool after it)
STAGES = (("conv1", 4, 2, True), ("conv2", 1, 2, True),
          ("conv3", 1, 1, False), ("conv4", 1, 1, False),
          ("conv5", 1, 1, False))


@contextlib.contextmanager
def _full_f32():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _normalize(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt((feat * feat).sum(dim=1, keepdim=True))
    return feat / (norm + eps)


def make_lpips(params: dict, normalize: bool = False):
    """lpips(img1, img2) on (3, H, W) images in [0, 1], with `params` the
    weights as tensors (io/convert.py:lpips_params_to_torch) on the device
    the images come on.

    normalize mirrors the lpips package's flag: True rescales [0, 1] input
    to [-1, 1] before the shift/scale layer; False feeds the input straight
    to it, as the reference's eval does (lpips.LPIPS without normalize on
    [0, 1] images, eval/utils.py:16-20, run.py:123-130), so the default
    reproduces the reference's LPIPS numbers."""
    shift = params["shift"].reshape(1, 3, 1, 1)
    scale = params["scale"].reshape(1, 3, 1, 1)

    def features(x):
        if normalize:
            x = 2.0 * x - 1.0
        h = (x - shift) / scale
        feats = []
        for name, stride, pad, pool in STAGES:
            h = torch.clamp(F.conv2d(h, params[f"{name}_w"],
                                     params[f"{name}_b"], stride, pad),
                            min=0.0)
            feats.append(h)
            if pool:
                h = F.max_pool2d(h, 3, 2)
        return feats

    def lpips(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """img1, img2: (3, H, W) in [0, 1]. Returns a 0-d tensor."""
        with torch.no_grad(), _full_f32():
            f1 = features(img1[None])
            f2 = features(img2[None])
            total = torch.zeros((), dtype=torch.float32, device=img1.device)
            for i, (a, b) in enumerate(zip(f1, f2)):
                d = (_normalize(a) - _normalize(b)) ** 2
                w = params[f"lin{i}"].reshape(1, -1, 1, 1)
                total = total + (d * w).sum(dim=1).mean()
        return total

    return lpips
