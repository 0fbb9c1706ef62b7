"""K-nearest-neighbour mean squared distance for anchor scale initialisation.

Port of segs_slam_tpu/ops/knn.py, which has no Pallas kernel: a chunked
brute-force `torch.cdist` plus `topk`. Matches simple-knn's distCUDA2
semantics (reference: third_party/simple-knn/spatial.cu:15-26): the mean of
the SQUARED distances to the k nearest other points.
"""

from __future__ import annotations

import torch


def mean_knn_sq_dist(points: torch.Tensor, valid: torch.Tensor | None = None,
                     k: int = 3, block: int = 1024) -> torch.Tensor:
    """points (N, 3) -> (N,) mean of squared distances to the k nearest
    others. `valid` masks padded rows: they are never neighbours and get 0.
    With fewer than k valid neighbours the mean is inf."""
    n = points.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=points.device)
    out = torch.empty((n,), dtype=points.dtype, device=points.device)
    cols = torch.arange(n, device=points.device)
    for s in range(0, n, block):
        q = points[s:s + block]
        d2 = torch.cdist(q, points,
                         compute_mode="donot_use_mm_for_euclid_dist") ** 2
        rows = torch.arange(s, s + q.shape[0], device=points.device)
        d2 = d2.masked_fill((rows[:, None] == cols[None, :]) | ~valid[None, :],
                            float("inf"))
        if n < k:
            d2 = torch.nn.functional.pad(d2, (0, k - n), value=float("inf"))
        nearest = torch.topk(d2, k, dim=-1, largest=False).values
        out[s:s + block] = torch.where(valid[s:s + block],
                                       nearest.mean(dim=-1), 0.0)
    return out
