"""The plain reference of the exact binning (RasterConfig compact = kmax =
0): the published rasterizer's (gaussian, tile) pairs, every tile of every
alive gaussian's whole rect, with no compaction cap and no footprint clamp.

Float32 PyTorch, TF32 off, importing nothing of the port. It takes
`reference.py`'s unchanged pieces (decode, cov3d, the projection, the loss,
Adam, densification, the keyframe sampler) and replaces two: the
projection's clamp is taken out (a rect inside the grid never holds more
tiles than the grid, so at kmax = the grid's tile count no rect shrinks),
and the pair selection keeps every touched tile of every alive gaussian.
The blend is `reference.blend`'s dense per-tile compositing, computed in
groups of tiles whose backward recomputes its group (torch.utils.
checkpoint), so that a view of millions of pairs fits on the card.

A bounded configuration (kmax > 0) is handed to `reference.train_steps`
unchanged, so a cell of any configuration may use this module.

`precision` takes "f32", "tf32" (the control) and two planted faults:
"half_image" (reference.py's) and "kmax8" (every footprint clamped to 8
tiles around its centre, as the bounded binning clamps it).
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from port_bench import reference as ref

FAULT_KMAX = 8


def project(means, cov, cam, w, h, rc, valid_in, kmax: int | None = None):
    """reference.project with no footprint clamp, or with a clamp to
    `kmax` tiles (the planted fault)."""
    ntx, nty = ref.grid(rc, w, h)
    return ref.project(means, cov, cam, w, h,
                       dict(rc, kmax=kmax or ntx * nty), valid_in)


def all_pairs(p, opacity, ntx):
    """(gaussian, tile) of every tile of every alive gaussian's rect, the
    gaussians in index order and each rect row by row."""
    alive = p["alive"] & torch.isfinite(opacity)
    touched = torch.where(alive, p["touched"], 0).long()
    rows = torch.nonzero(touched).squeeze(1)
    n = touched[rows]
    gid = torch.repeat_interleave(rows, n)
    k = torch.arange(gid.shape[0], device=gid.device) \
        - torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    rw = torch.clamp(p["rect_w"][gid].long(), min=1)
    tile = ((p["rect_y"][gid].long() + k // rw) * ntx
            + p["rect_x"][gid].long() + k % rw)
    return gid, tile


def _group_colour(f, inside, px, py, bg, alpha_min, alpha_clamp, t_min):
    """`reference.blend`'s compositing of one group of tiles: f [9, B, L]
    (mean2d x, y, conic a, b, c, opacity, r, g, b), inside [B, L], the
    pixels px, py [B, P]. Returns the tiles' colour [B, 3, P]."""
    dx = f[0][:, None] - px[:, :, None]
    dy = f[1][:, None] - py[:, :, None]
    power = (-0.5 * (f[2][:, None] * dx * dx + f[4][:, None] * dy * dy)
             - f[3][:, None] * dx * dy)
    opg = f[5][:, None] * torch.exp(power)
    clamped = torch.clamp(opg, max=alpha_clamp)
    alpha = opg + (clamped - opg).detach()  # straight through the clamp
    ok = (inside[:, None] & (power <= 0.0) & (clamped >= alpha_min)).detach()
    alpha = torch.where(ok, alpha, 0.0)
    cum = torch.cumprod(1.0 - alpha, -1)
    before = torch.cat([torch.ones_like(cum[..., :1]), cum[..., :-1]], -1)
    accept = (cum >= t_min).detach()
    wgt = torch.where(accept, alpha * before, 0.0)
    T = torch.where(accept, cum, 1.0).amin(-1)
    return (torch.einsum("bpl,cbl->bcp", wgt, f[6:9])
            + bg.reshape(1, 3, 1) * T[:, None, :])


def blend(feat, depth, gid, tile, rc, bg, w, h):
    """`reference.blend` (front-to-back compositing of each tile's pairs in
    depth order, dense per tile) in groups of tiles, each recomputed in the
    backward rather than kept. feat [9, N]. Returns the image (3, H, W)."""
    ntx, nty = ref.grid(rc, w, h)
    nt, b = ntx * nty, rc["tile"]
    npix = b * b
    dev = feat.device
    order = torch.argsort(depth.detach()[gid], stable=True)
    order = order[torch.argsort(tile[order], stable=True)]
    gid, tile = gid[order], tile[order]
    counts = torch.bincount(tile, minlength=nt)
    starts = torch.cumsum(counts, 0) - counts
    p = torch.arange(npix, device=dev)
    parts, t_done = [], 0
    empty = bg.reshape(1, 3, 1).expand(nt, 3, npix)
    for t0, t1, length in ref._groups(counts.tolist(), npix):
        if t0 > t_done:
            parts.append(empty[t_done:t0])
        j = torch.arange(length, device=dev)
        inside = j[None] < counts[t0:t1, None]
        idx = torch.where(inside, starts[t0:t1, None] + j[None], 0)
        f = feat[:, gid[idx]]  # [9, B, L]
        t = torch.arange(t0, t1, device=dev)
        px = ((t % ntx) * b).float()[:, None] + (p % b).float()[None]
        py = ((t // ntx) * b).float()[:, None] + (p // b).float()[None]
        parts.append(torch.utils.checkpoint.checkpoint(
            _group_colour, f, inside, px, py, bg, rc["alpha_min"],
            rc["alpha_clamp"], rc["transmittance_min"], use_reentrant=False))
        t_done = t1
    if t_done < nt:
        parts.append(empty[t_done:])
    tiles_out = torch.cat(parts)
    return (tiles_out.reshape(nty, ntx, 3, b, b).permute(2, 0, 3, 1, 4)
            .reshape(3, nty * b, ntx * b)[:, :h, :w])


def render(anchors, dec, cam, mc, rc, w, h, bg, precision="f32",
           mean2d_offset=None):
    """The view's image and what the loss and the statistics read, as
    `reference.render` returns them, through the exact binning."""
    ntx, nty = ref.grid(rc, w, h)
    whole = dict(rc, kmax=ntx * nty)  # no anchor rect shrinks either
    g = ref.decode(anchors, dec, cam, mc, whole, w, h)
    p = project(g["xyz"], ref.cov3d(g["scaling"], g["rotation"]), cam, w, h,
                rc, g["valid"], FAULT_KMAX if precision == "kmax8" else None)
    mean2d = p["mean2d"] if mean2d_offset is None else \
        p["mean2d"] + mean2d_offset
    feat = torch.cat([mean2d.T, p["conic"].T, g["opacity"][None],
                      g["color"].T])
    gid, tile = all_pairs(p, g["opacity"], ntx)
    img = blend(feat, p["depth"], gid, tile, rc, bg, w, h)
    return {"image": img, "neural": g, "proj": p, "pairs": gid.shape[0]}


def train_steps(anchors, dec, stats, cams, gts, kf_ids, start_it, n_steps,
                mc, oc, rc, w, h, seed, times_of_use, precision="f32"):
    """`reference.train_steps` through the exact binning (a bounded rc goes
    to reference.train_steps itself): n_steps iterations from `start_it`,
    each sampling a keyframe, rendering, taking the loss, its gradients,
    the densification statistics and a masked Adam step, and densifying
    when due. Returns (kf ids sampled, losses, the first step's gradient
    leaves, the final parameters)."""
    if rc["kmax"]:
        return ref.train_steps(anchors, dec, stats, cams, gts, kf_ids,
                               start_it, n_steps, mc, oc, rc, w, h, seed,
                               times_of_use, precision)
    dev = anchors["anchor"].device
    a = {n: v.clone() for n, v in anchors.items()}
    d = {n: v.clone() for n, v in dec.items()}
    st = {"anchors": a, "stats": {n: v.clone() for n, v in stats.items()}}
    paths = [("anchors", n) for n in ref.ANCHOR_FIELDS] + \
        [("decoders", n) for n in d]
    st["mu"] = {p: torch.zeros_like(_leaf(st, d, p)) for p in paths}
    st["nu"] = {p: torch.zeros_like(_leaf(st, d, p)) for p in paths}
    sampler = ref.Sampler(kf_ids, times_of_use, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bg = torch.zeros(3, device=dev)
    cap, k = a["anchor"].shape[0], mc["n_offsets"]
    sampled, losses, first = [], [], None
    with ref.matmul_precision(precision):
        for n in range(n_steps):
            it = start_it + n + 1
            kid = sampler.next()
            sampled.append(kid)
            leaves = {p: _leaf(st, d, p).detach().requires_grad_()
                      for p in paths}
            an = dict(a, **{p[1]: leaves[p] for p in paths
                            if p[0] == "anchors"})
            dd = {p[1]: leaves[p] for p in paths if p[0] == "decoders"}
            m2d = torch.zeros((cap * k, 2), device=dev, requires_grad=True)
            out = render(an, dd, cams[kid], mc, rc, w, h, bg, precision,
                         m2d)
            gt = gts[kid]
            if precision == "half_image":  # the fault: half the rows left out
                out = dict(out, image=out["image"][:, :h // 2])
                gt = gt[:, :h // 2]
            loss = ref.step_loss(out, gt, it, oc)
            gl = torch.autograd.grad(loss, [*leaves.values(), m2d],
                                     allow_unused=True)
            gl = [torch.zeros_like(x) if g is None else
                  torch.where(torch.isfinite(g), g, 0.0)
                  for x, g in zip([*leaves.values(), m2d], gl)]
            grads = dict(zip(paths, gl[:-1]))
            losses.append(float(loss.detach()))
            del out["image"], loss
            with torch.no_grad():
                if oc["start_stat"] < it < oc["update_until"]:
                    s = st["stats"]
                    vis = out["neural"]["visible"]
                    comb = (torch.repeat_interleave(vis, k)
                            & out["neural"]["offset_mask"]
                            & (out["proj"]["radius"] > 0)).reshape(cap, k)
                    g2 = gl[-1] * torch.tensor([0.5 * w, 0.5 * h], device=dev)
                    gn = torch.sqrt((g2 * g2).sum(-1)).reshape(cap, k)
                    op = out["neural"]["opacity"].reshape(cap, k)
                    s["opacity_accum"] += vis.float() * torch.clamp(
                        op, min=0.0).sum(1)
                    s["anchor_demon"] += vis.float()
                    s["offset_grad_accum"] += comb.float() * gn
                    s["offset_denom"] += comb.float()
                if first is None:
                    first = {p: torch.where(
                        a["active"].reshape((-1,) + (1,) * (g.dim() - 1)),
                        g, 0.0) if p[0] == "anchors" else g.clone()
                        for p, g in grads.items()}
                params = {p: _leaf(st, d, p) for p in paths}
                ref.adam(params, grads, st["mu"], st["nu"], n + 1, it, oc,
                         a["active"])
                if (oc["update_from"] < it < oc["update_until"]
                        and it % oc["update_interval"] == 0):
                    ref.densify(st, mc, oc, gen)
                    a = st["anchors"]
            del out, gl, grads, leaves, an, dd, m2d
    final = {p: _leaf(st, d, p).detach() for p in paths}
    final[("anchors", "active")] = st["anchors"]["active"]
    return sampled, losses, first, final


def _leaf(st, dec, path):
    return st["anchors"][path[1]] if path[0] == "anchors" else dec[path[1]]
