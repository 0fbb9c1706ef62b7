"""The plain reference of a live map's first iterations: the mapper's
initial map from the first keyframes' points, then training steps with a
keyframe and its points arriving before each later step.

Float32 PyTorch, TF32 off, importing nothing of the port. It follows the
published description: the initial anchors and each later insertion as
createFromPcd / increasePcd make them (src/gaussian_model.cpp:344-420: the
points rounded to the voxel grid and deduplicated, each new anchor's scale
log sqrt of the mean squared distance to its 3 nearest neighbours among the
new points and the active anchors, simple-knn's distCUDA2; identity
rotation, opacity logit(0.1), zero offsets and features), the sliding
window's shuffle drawn anew when a keyframe arrives
(src/gaussian_mapper.cpp:1459-1495), and `reference.py`'s render, loss and
Adam for each step (its unchanged pieces). The compared iterations lie
before the densification statistics start (start_stat), so no statistic or
densification enters them.

`precision` takes what `reference.render` takes ("f32", "tf32",
"fp8_blend") and the fault "half_image".
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench import reference as ref


def voxelize(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """The points rounded to the voxel grid, each cell once, in the grid's
    lexicographic order."""
    cells = np.unique(np.round(np.asarray(points, np.float64) / voxel_size),
                      axis=0)
    return (cells * voxel_size).astype(np.float32)


def knn_mean_sq(cloud: torch.Tensor, rows: int, k: int = 3,
                block: int = 1024) -> torch.Tensor:
    """The mean squared distance of each of the first `rows` points of
    `cloud` to its k nearest other points (inf with fewer than k)."""
    out = []
    for s in range(0, rows, block):
        q = cloud[s:min(s + block, rows)]
        d2 = ((q[:, None, :] - cloud[None, :, :]) ** 2).sum(-1)
        d2[torch.arange(q.shape[0]), torch.arange(s, s + q.shape[0])] = \
            math.inf
        if cloud.shape[0] < k:
            d2 = torch.nn.functional.pad(d2, (0, k - cloud.shape[0]),
                                         value=math.inf)
        out.append(torch.topk(d2, k, dim=-1, largest=False).values.mean(-1))
    return torch.cat(out)


def insert(a: dict, points: np.ndarray, mc: dict) -> None:
    """increasePcd on the anchors `a` (in place): the voxelized points
    appended after the active anchors, as far as the capacity holds."""
    fused = voxelize(points, mc["voxel_size"])
    n_active = int(a["active"].sum())
    n_new = min(fused.shape[0], a["anchor"].shape[0] - n_active)
    if n_new <= 0:
        return
    dev = a["anchor"].device
    new = torch.as_tensor(fused[:n_new], device=dev)
    d2 = knn_mean_sq(torch.cat([new, a["anchor"][:n_active]]), n_new)
    d2 = torch.clamp(torch.where(torch.isfinite(d2), d2,
                                 mc["voxel_size"] ** 2), min=1e-7)
    sl = slice(n_active, n_active + n_new)
    a["anchor"][sl] = new
    a["scaling"][sl] = torch.log(torch.sqrt(d2))[:, None]
    a["rotation"][sl] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    a["opacity"][sl] = math.log(0.1 / 0.9)
    a["offset"][sl] = 0.0
    a["feat"][sl] = 0.0
    a["active"][sl] = True


def empty_map(mc: dict, device) -> dict:
    """A map of `capacity` free slots (the values insert() overwrites)."""
    cap, k, f = mc["capacity"], mc["n_offsets"], mc["feat_dim"]
    rot = torch.zeros((cap, 4), device=device)
    rot[:, 0] = 1.0
    return {"anchor": torch.zeros((cap, 3), device=device),
            "offset": torch.zeros((cap, k, 3), device=device),
            "feat": torch.zeros((cap, f), device=device),
            "scaling": torch.zeros((cap, 6), device=device),
            "rotation": rot,
            "opacity": torch.full((cap, 1), math.log(0.1 / 0.9),
                                  device=device),
            "active": torch.zeros(cap, dtype=torch.bool, device=device)}


class LiveSampler(ref.Sampler):
    """The sliding-window sampler with keyframes arriving: each arrival
    gets its times-of-use budget, and the window's order is shuffled anew
    over every keyframe so far, in arrival order, before the next draw."""

    def add(self, kid, times_of_use: int) -> None:
        self.remaining[kid] = times_of_use
        self.order = list(self.remaining)
        self.rng.shuffle(self.order)
        self.idx = 0


def live_steps(initial_ids, initial_points, arrivals, dec, cams, gts, mc,
               oc, rc, w, h, seed, times_of_use, radius, precision="f32"):
    """The map initialised from `initial_points` (the keyframes
    `initial_ids`' points), then one step per entry of `arrivals`: None, or
    (kf id, its points) arriving before the step. `radius` is the initial
    keyframes' nerf++ radius, the spatial learning-rate scale. Returns (the
    parameters after initialisation, kf ids sampled, losses, the first
    step's gradient leaves, the final parameters)."""
    dev = next(iter(dec.values())).device
    a = empty_map(mc, dev)
    insert(a, np.asarray(initial_points), mc)
    d = {n: v.clone() for n, v in dec.items()}
    paths = [("anchors", n) for n in ref.ANCHOR_FIELDS] + \
        [("decoders", n) for n in d]

    def leaf(p):
        return a[p[1]] if p[0] == "anchors" else d[p[1]]

    init = {p: leaf(p).detach().clone() for p in paths}
    init[("anchors", "active")] = a["active"].clone()
    mu = {p: torch.zeros_like(leaf(p)) for p in paths}
    nu = {p: torch.zeros_like(leaf(p)) for p in paths}
    sampler = LiveSampler(initial_ids, times_of_use, seed)
    oc = dict(oc, spatial_lr_scale=radius)
    bg = torch.zeros(3, device=dev)
    cap, k = mc["capacity"], mc["n_offsets"]
    assert len(arrivals) < oc["start_stat"]  # no statistics, no densify
    sampled, losses, first = [], [], None
    with ref.matmul_precision(precision):
        for n, arrival in enumerate(arrivals):
            it = n + 1
            if arrival is not None:
                kid, pts = arrival
                insert(a, np.asarray(pts), mc)
                sampler.add(kid, times_of_use)
            kid = sampler.next()
            sampled.append(kid)
            leaves = {p: leaf(p).detach().requires_grad_() for p in paths}
            an = dict(a, **{p[1]: leaves[p] for p in paths
                            if p[0] == "anchors"})
            dd = {p[1]: leaves[p] for p in paths if p[0] == "decoders"}
            out = ref.render(an, dd, cams[kid], mc, rc, w, h, bg,
                             precision=precision,
                             mean2d_offset=torch.zeros((cap * k, 2),
                                                       device=dev))
            gt = gts[kid]
            if precision == "half_image":  # the fault: half the rows left out
                out = dict(out, image=out["image"][:, :h // 2])
                gt = gt[:, :h // 2]
            loss = ref.step_loss(out, gt, it, oc)
            gl = torch.autograd.grad(loss, list(leaves.values()),
                                     allow_unused=True)
            grads = {p: torch.zeros_like(leaves[p]) if g is None else
                     torch.where(torch.isfinite(g), g, 0.0)
                     for p, g in zip(paths, gl)}
            losses.append(float(loss.detach()))
            with torch.no_grad():
                if first is None:
                    first = {p: torch.where(
                        a["active"].reshape((-1,) + (1,) * (g.dim() - 1)),
                        g, 0.0) if p[0] == "anchors" else g.clone()
                        for p, g in grads.items()}
                ref.adam({p: leaf(p) for p in paths}, grads, mu, nu, n + 1,
                         it, oc, a["active"])
    final = {p: leaf(p).detach() for p in paths}
    final[("anchors", "active")] = a["active"]
    return init, sampled, losses, first, final
