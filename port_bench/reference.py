"""The plain reference that decides `correct`: the map's render, loss,
gradients, Adam update and densification, and the eval render, in float32
PyTorch with no kernel, no packing and no program state.

It follows the published description (SEGS-SLAM's GaussianRenderer and
trainForOneIteration; 3D Gaussian Splatting's rasterizer) with the port's
documented static-shape rules, which decide which (gaussian, tile) pairs a
view composites: each footprint clamped to kmax tiles around its centre;
the training binning's opacity-priority compaction to `compact` gaussians,
ksmall slots for each and kmax for the nlarge largest; the eval binning's
footprint-then-opacity selection with its three tiers. The blend is dense
per tile and differentiated by autograd, with the 0.99 alpha clamp passed
straight through as the reference's backward does. Importing neither JAX,
the JAX package nor the port, it is an independent second reading.

`precision` selects the control: "f32" (the reference), "tf32" (matmuls in
TF32), "fp8_blend" (each gaussian's blend inputs rounded through float8
e4m3, the step below the packed training binning's float16) and
"int4_colour" (colours on 4 bits, the step below pack8's bytes); and one
planted fault of a training step, "half_image" (the loss over the image's
top half, its mean taken over the rest).
"""

from __future__ import annotations

import contextlib
import math
import random

import numpy as np
import torch
import torch.nn.functional as F

DEAD_KEY = 1 << 24
SEL_DEAD = (1 << 32) - 1
DECODER_GROUP = {"opacity": "mlp_opacity", "cov": "mlp_cov",
                 "color": "mlp_color", "appearance": "appearance",
                 "embedding": "appearance"}
ANCHOR_FIELDS = ("anchor", "offset", "feat", "scaling", "rotation", "opacity")


@contextlib.contextmanager
def matmul_precision(precision: str):
    """TF32 matmuls for the "tf32" control, full float32 otherwise."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def to_int32(x):
    """f32 -> int32 truncating, saturating, NaN -> 0."""
    x = torch.nan_to_num(x, nan=0.0).clamp(-2.0**31, 2.0**31)
    return x.to(torch.int64).clamp(-2**31, 2**31 - 1).to(torch.int32)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _linear(x, dec, name):
    return x @ dec[name + ".weight"].T + dec[name + ".bias"]


def _mlp(x, dec, name):
    return _linear(torch.relu(_linear(x, dec, name + ".l1")), dec,
                   name + ".l2")


# --- projection (3DGS preprocessCUDA, forward.cu:74-256) --------------------

def cov3d(scales, quats):
    w, x, y, z = quats.unbind(-1)
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)
    s2 = scales * scales
    r = lambda i, j: R[:, i, j]  # noqa: E731
    out = []
    for i, j in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
        out.append(r(i, 0) * r(j, 0) * s2[:, 0] + r(i, 1) * r(j, 1) * s2[:, 1]
                   + r(i, 2) * r(j, 2) * s2[:, 2])
    return torch.stack(out, -1)


def _rows(p, M):
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    return [x * M[0, j] + y * M[1, j] + z * M[2, j] + M[3, j]
            for j in range(4)]


def _away(v, eps):
    return torch.where(v.abs() < eps, torch.where(v < 0, -eps, eps), v)


def project(means, cov, cam, w, h, rc, valid_in):
    """Screen-space mean, conic, depth, radius, the kmax-clamped tile rect
    and its tile count of each gaussian (0 where culled)."""
    wvt, fpt = cam["world_view_transform"], cam["full_proj_transform"]
    tan_x, tan_y = cam["tan_fovx"], cam["tan_fovy"]
    fx, fy = w / (2.0 * tan_x), h / (2.0 * tan_y)
    tx0, ty0, tz, _ = _rows(means, wvt)
    depth = tz
    hx, hy, _, hw = _rows(means, fpt)
    p_w = 1.0 / _away(hw + 1.0e-7, 1e-6)
    mean2d = torch.stack([((hx * p_w + 1.0) * w - 1.0) * 0.5,
                          ((hy * p_w + 1.0) * h - 1.0) * 0.5], -1)
    tz = _away(tz, 1e-6)
    limx, limy = 1.3 * tan_x, 1.3 * tan_y
    txc = _clip(tx0 / tz, -limx, limx) * tz
    tyc = _clip(ty0 / tz, -limy, limy) * tz
    inv_z = 1.0 / tz
    j00, j02 = fx * inv_z, -fx * txc * inv_z * inv_z
    j11, j12 = fy * inv_z, -fy * tyc * inv_z * inv_z
    W = [[wvt[j, i] for j in range(3)] for i in range(3)]
    m0 = [j00 * W[0][c] + j02 * W[2][c] for c in range(3)]
    m1 = [j11 * W[1][c] + j12 * W[2][c] for c in range(3)]
    c0, c1, c2, c3, c4, c5 = cov.unbind(-1)
    v0 = [c0 * m[0] + c1 * m[1] + c2 * m[2] for m in (m0, m1)]
    v1 = [c1 * m[0] + c3 * m[1] + c4 * m[2] for m in (m0, m1)]
    v2 = [c2 * m[0] + c4 * m[1] + c5 * m[2] for m in (m0, m1)]
    a = m0[0] * v0[0] + m0[1] * v1[0] + m0[2] * v2[0] + 0.3
    b = m0[0] * v0[1] + m0[1] * v1[1] + m0[2] * v2[1]
    c = m1[0] * v0[1] + m1[1] * v1[1] + m1[2] * v2[1] + 0.3
    det = a * c - b * b
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], -1)
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    r = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0))).detach()
    valid = (depth > rc["near"]) & (det != 0.0) & valid_in
    tile = float(rc["tile"])
    ntx, nty = grid(rc, w, h)
    px, py = mean2d[:, 0].detach(), mean2d[:, 1].detach()
    rx0 = to_int32(torch.clamp(torch.floor((px - r) / tile), 0, ntx))
    ry0 = to_int32(torch.clamp(torch.floor((py - r) / tile), 0, nty))
    rx1 = to_int32(torch.clamp(torch.floor((px + r + tile - 1) / tile), 0, ntx))
    ry1 = to_int32(torch.clamp(torch.floor((py + r + tile - 1) / tile), 0, nty))
    # a footprint over kmax tiles shrinks around its centre
    km = rc["kmax"]
    rw, rh = rx1 - rx0, ry1 - ry0
    over = (rw * rh) > km
    ratio = torch.sqrt(km / torch.clamp((rw * rh).float(), min=1.0))
    w2 = torch.clamp(torch.clamp(to_int32(rw.float() * ratio), min=1), max=km)
    h2 = torch.minimum(torch.clamp(km // torch.clamp(w2, min=1), min=1), rh)
    w2, h2 = torch.where(over, w2, rw), torch.where(over, h2, rh)
    cx = _clip(to_int32(px / tile), rx0, rx1 - 1)
    cy = _clip(to_int32(py / tile), ry0, ry1 - 1)
    nx = _clip(cx - w2 // 2, rx0, rx1 - w2)
    ny = _clip(cy - h2 // 2, ry0, ry1 - h2)
    rx0, ry0 = torch.where(over, nx, rx0), torch.where(over, ny, ry0)
    rx1, ry1 = torch.where(over, nx + w2, rx1), torch.where(over, ny + h2, ry1)
    touched = (rx1 - rx0) * (ry1 - ry0)
    valid = valid & (touched > 0)
    return {"mean2d": mean2d, "conic": conic, "depth": depth,
            "radius": torch.where(valid, r, 0.0), "alive": valid,
            "rect_x": rx0, "rect_y": ry0, "rect_w": rx1 - rx0,
            "touched": torch.where(valid, touched, 0)}


def grid(rc, w, h):
    return (w + rc["tile"] - 1) // rc["tile"], (h + rc["tile"] - 1) // rc["tile"]


# --- decode (GaussianRenderer, src/gaussian_renderer.cpp:19-334) ------------

def decode(anchors, dec, cam, mc, rc, w, h):
    """The visibility prefilter and the neural gaussians of every slot."""
    cap, k = anchors["anchor"].shape[0], mc["n_offsets"]
    rot = anchors["rotation"]
    rot = rot / torch.clamp(torch.linalg.norm(rot, dim=-1, keepdim=True),
                            min=1e-12)
    cov_a = cov3d(torch.exp(anchors["scaling"][:, :3]), rot).detach()
    visible = project(anchors["anchor"].detach(), cov_a, cam, w, h, rc,
                      anchors["active"])["alive"]
    feat, anchor = anchors["feat"], anchors["anchor"]
    grid_scaling = torch.exp(anchors["scaling"])
    ob = anchor - cam["camera_center"][None, :]
    dist = torch.sqrt((ob * ob).sum(-1, keepdim=True) + 1e-12)
    local = torch.cat([feat, ob / dist], -1)
    neural_opacity = torch.tanh(_mlp(local, dec, "opacity"))
    color_in = local
    if mc["appearance_dim"] > 0:
        app = _linear(cam["pose7"][None, :], dec, "appearance")
        color_in = torch.cat([local, app.expand(cap, -1)], -1)
    color = torch.sigmoid(_mlp(color_in, dec, "color")).reshape(cap * k, 3)
    sr = _mlp(local, dec, "cov").reshape(cap * k, 7)
    scaling = (torch.repeat_interleave(grid_scaling[:, 3:6], k, 0)
               * torch.sigmoid(sr[:, :3]))
    q = sr[:, 3:7]
    q = q / torch.sqrt((q * q).sum(-1, keepdim=True) + 1e-24)
    xyz = (torch.repeat_interleave(anchor, k, 0)
           + anchors["offset"].reshape(cap * k, 3)
           * torch.repeat_interleave(grid_scaling[:, 0:3], k, 0))
    offset_mask = (neural_opacity > 0.0).reshape(-1)
    valid = (torch.repeat_interleave(anchors["active"] & visible, k)
             & offset_mask)
    return {"xyz": xyz, "color": color, "opacity": neural_opacity.reshape(-1),
            "scaling": scaling, "rotation": q, "valid": valid,
            "offset_mask": offset_mask, "visible": visible}


# --- which (gaussian, tile) pairs a view composites -------------------------

def _opac_q(op):
    return to_int32(65535.0 * (1.0 - torch.clamp(op, 0.0, 1.0))).long()


def _slots(rx, ry, rw, touched, k_lo, k_hi, ntx):
    """(row index, tile) of slots [k_lo, k_hi) below each row's count."""
    k = torch.arange(k_lo, k_hi, device=rx.device)[None]
    ok = k < touched[:, None]
    rw = torch.clamp(rw, min=1)[:, None]
    dy = k // rw
    tile = (ry[:, None] + dy) * ntx + rx[:, None] + (k - dy * rw)
    rows = torch.arange(rx.shape[0], device=rx.device)[:, None].expand_as(ok)
    return rows[ok], tile[ok]


def select_pairs(p, opacity, rc, eval_path: bool, ntx):
    """(gaussian, tile) of every instance the binning keeps, in expansion
    order. Training: the `compact` most opaque gaussians, ksmall slots each,
    the rest of their footprint for the nlarge largest. Eval (sel_direct):
    gaussians ordered by footprint then opacity; the first `compact` get
    ksmall slots, the first nmid up to kmid, the first nlarge up to kmax."""
    alive = p["alive"] & torch.isfinite(opacity)
    km, ks, nc = rc["kmax"], rc["ksmall"], rc["compact"]
    touched = torch.clamp(p["touched"].long(), max=km)
    if eval_path:
        key = torch.where(alive, ((km - touched) << 16) | _opac_q(opacity),
                          SEL_DEAD)
        order = torch.sort(key, stable=True).indices
        tiers = [(order[:nc], 0, ks), (order[:rc["nmid"]], ks, rc["kmid"]),
                 (order[:rc["nlarge"]], rc["kmid"], km)]
    else:
        key = torch.where(alive, _opac_q(opacity), DEAD_KEY)
        order = torch.sort(key, stable=True).indices[:nc]
        t_c = torch.where(alive[order], touched[order], 0)
        sel = torch.sort(torch.where(t_c <= ks, km + 1, km - t_c),
                         stable=True).indices[:rc["nlarge"]]
        tiers = [(order, 0, ks), (order[sel], ks, km)]
    gids, tiles = [], []
    for rows, lo, hi in tiers:
        t = torch.where(alive[rows], touched[rows], 0)
        r, tile = _slots(p["rect_x"][rows].long(), p["rect_y"][rows].long(),
                         p["rect_w"][rows].long(), t, lo, hi, ntx)
        gids.append(rows[r])
        tiles.append(tile)
    return torch.cat(gids), torch.cat(tiles)


# --- the blend (forward.cu renderCUDA, dense per tile) ----------------------

GROUP_ELEMS = 1 << 24


def _groups(counts, npix):
    t0, nt = 0, len(counts)
    while t0 < nt:
        t1, longest = t0 + 1, counts[t0]
        while t1 < nt and (t1 - t0 + 1) * npix * max(longest, counts[t1]) \
                <= GROUP_ELEMS:
            longest = max(longest, counts[t1])
            t1 += 1
        if longest > 0:
            yield t0, t1, longest
        t0 = t1


def blend(feat, depth, gid, tile, rc, bg, w, h):
    """Front-to-back compositing of each tile's pairs in depth order.
    feat [9, N]: mean2d x, y, conic a, b, c, opacity, r, g, b. Returns the
    image (3, H, W)."""
    ntx, nty = grid(rc, w, h)
    nt, b = ntx * nty, rc["tile"]
    npix = b * b
    dev = feat.device
    order = torch.argsort(depth.detach()[gid], stable=True)
    order = order[torch.argsort(tile[order], stable=True)]
    gid, tile = gid[order], tile[order]
    counts = torch.bincount(tile, minlength=nt)
    starts = torch.cumsum(counts, 0) - counts
    counts_l = counts.tolist()
    p = torch.arange(npix, device=dev)
    tiles_out = bg.reshape(1, 3, 1).expand(nt, 3, npix).clone()
    for t0, t1, length in _groups(counts_l, npix):
        j = torch.arange(length, device=dev)
        inside = j[None] < counts[t0:t1, None]
        idx = torch.where(inside, starts[t0:t1, None] + j[None], 0)
        f = feat[:, gid[idx]]  # [9, B, L]
        t = torch.arange(t0, t1, device=dev)
        px = ((t % ntx) * b).float()[:, None] + (p % b).float()[None]
        py = ((t // ntx) * b).float()[:, None] + (p // b).float()[None]
        dx = f[0][:, None] - px[:, :, None]
        dy = f[1][:, None] - py[:, :, None]
        power = (-0.5 * (f[2][:, None] * dx * dx + f[4][:, None] * dy * dy)
                 - f[3][:, None] * dx * dy)
        opg = f[5][:, None] * torch.exp(power)
        clamped = torch.clamp(opg, max=rc["alpha_clamp"])
        alpha = opg + (clamped - opg).detach()  # straight through the clamp
        ok = (inside[:, None] & (power <= 0.0)
              & (clamped >= rc["alpha_min"])).detach()
        alpha = torch.where(ok, alpha, 0.0)
        cum = torch.cumprod(1.0 - alpha, -1)
        before = torch.cat([torch.ones_like(cum[..., :1]), cum[..., :-1]], -1)
        accept = (cum >= rc["transmittance_min"]).detach()
        wgt = torch.where(accept, alpha * before, 0.0)
        T = torch.where(accept, cum, 1.0).amin(-1)
        tiles_out[t0:t1] = (torch.einsum("bpl,cbl->bcp", wgt, f[6:9])
                            + bg.reshape(1, 3, 1) * T[:, None, :])
    img = (tiles_out.reshape(nty, ntx, 3, b, b).permute(2, 0, 3, 1, 4)
           .reshape(3, nty * b, ntx * b)[:, :h, :w])
    return img


def render(anchors, dec, cam, mc, rc, w, h, bg, eval_path=False,
           precision="f32", mean2d_offset=None):
    """The view's image and what the loss and the statistics read."""
    g = decode(anchors, dec, cam, mc, rc, w, h)
    p = project(g["xyz"], cov3d(g["scaling"], g["rotation"]), cam, w, h, rc,
                g["valid"])
    mean2d = p["mean2d"] if mean2d_offset is None else p["mean2d"] + \
        mean2d_offset
    colour = g["color"]
    if precision == "int4_colour":  # 4-bit colours: pack8's bytes less half
        colour = torch.round(torch.clamp(colour, 0, 1) * 15.0) / 15.0
    feat = torch.cat([mean2d.T, p["conic"].T, g["opacity"][None],
                      colour.T])
    if precision == "fp8_blend":
        # each blend input through float8 e4m3, the position relative to
        # its rect's corner as the packed layouts hold it
        corner = torch.stack([p["rect_x"], p["rect_y"]]).float() * rc["tile"]
        rel = torch.cat([feat[:2] - corner, feat[2:]])
        feat = feat + (rel.to(torch.float8_e4m3fn).float() - rel).detach()
    gid, tile = select_pairs(p, g["opacity"], rc, eval_path, grid(rc, w, h)[0])
    img = blend(feat, p["depth"], gid, tile, rc, bg, w, h)
    return {"image": img, "neural": g, "proj": p}


# --- loss (include/loss_utils.h, src/gaussian_mapper.cpp:917-948) -----------

def _band(n, device, size=11, sigma=1.5):
    xs = np.arange(size) - size // 2
    g = np.exp(-(xs**2) / (2.0 * sigma * sigma))
    g = (g / g.sum()).astype(np.float32)
    m = np.zeros((n, n), np.float32)
    for k, v in zip(range(-(size // 2), size // 2 + 1), g):
        m += np.diag(np.full(n - abs(k), v, np.float32), k)
    return torch.as_tensor(m, device=device)


def ssim(a, b):
    """Mean SSIM, 11 x 11 Gaussian window (sigma 1.5), zero padding."""
    _, h, w = a.shape
    mh, mw = _band(h, a.device), _band(w, a.device)

    def blur(x):
        return torch.einsum("ab,chb->cha", mw,
                            torch.einsum("ab,cbw->caw", mh, x))
    mu1, mu2 = blur(a), blur(b)
    s1 = blur(a * a) - mu1 * mu1
    s2 = blur(b * b) - mu2 * mu2
    s12 = blur(a * b) - mu1 * mu2
    c1, c2 = 0.01**2, 0.03**2
    return (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
            / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))).mean()


def high_freq(a, b):
    """Mean |amplitude spectrum difference| (the reference's masks are
    no-ops, loss_utils.h:147-165)."""
    def amp(x):
        z = torch.fft.fftshift(torch.fft.fft2(x))
        return torch.sqrt(z.real**2 + z.imag**2 + 1e-20)
    return (amp(a) - amp(b)).abs().mean()


def step_loss(out, gt, it, oc):
    img = out["image"]
    mask = (gt != 0.0).any(0, keepdim=True).float()
    img_m, gt_m = img * mask, gt * mask
    l1 = (img_m - gt_m).abs().mean()
    valid = out["neural"]["valid"].float()
    reg = ((torch.prod(out["neural"]["scaling"], -1) * valid).sum()
           / torch.clamp(valid.sum(), min=1.0))
    lam = oc["lambda_dssim"]
    loss = (1.0 - lam) * l1 + lam * (1.0 - ssim(img_m, gt_m)) + 0.01 * reg
    if (oc["use_frequency_regularization"]
            and oc["high_frequency_regularization_start"] < it
            < oc["frequency_regulization_until"]):
        high = torch.zeros((), device=img.device)
        n = oc["scale_num"] if oc["use_multi_resolution"] else 1
        _, h, w = img.shape
        for i in range(n):
            s = 1.0 / 2**i
            size = (int(round(h * s)), int(round(w * s)))

            def rs(x):
                return F.interpolate(x[None], size=size, mode="bilinear",
                                     align_corners=False, antialias=True)[0]
            high = high + s * high_freq(rs(img_m), rs(gt_m))
        loss = loss + oc["lambda_frequency_high"] * high
    return loss


# --- schedules and Adam (src/gaussian_model.cpp:874-998, :620-684) ----------

def expon_lr(init, final, step, max_steps):
    if init == 0.0 and final == 0.0:
        return 0.0
    f32 = np.float32
    t = np.clip(f32(step) / f32(max_steps), f32(0), f32(1))
    with np.errstate(divide="ignore"):
        return float(np.exp(np.log(f32(init)) * (f32(1) - t)
                            + np.log(f32(final)) * t))


def learning_rate(path, it, oc):
    s = oc["spatial_lr_scale"]
    if path[0] == "anchors":
        name = path[1]
        if name in ("anchor", "offset"):
            pre = "position" if name == "anchor" else "offset"
            return expon_lr(oc[pre + "_lr_init"] * s, oc[pre + "_lr_final"] * s,
                            it, oc[pre + "_lr_max_steps"])
        key = {"feat": "feature_lr"}.get(name, name + "_lr")
        return float(np.float32(oc[key]))
    group = DECODER_GROUP[path[1].split(".")[0]]
    return expon_lr(oc[group + "_lr_init"], oc[group + "_lr_final"], it,
                    oc[group + "_lr_max_steps"])


@torch.no_grad()
def adam(params, grads, mu, nu, count, it, oc, active):
    """One masked Adam step (b1 0.9, b2 0.999, eps 1e-15; inactive anchor
    rows frozen), in place; bias corrections in float32."""
    f32 = np.float32
    bc1 = float(f32(1) - f32(0.9) ** f32(count))
    bc2 = float(f32(1) - f32(0.999) ** f32(count))
    for path, p in params.items():
        g = grads[path]
        lr = learning_rate(path, it, oc)
        m2 = 0.9 * mu[path] + (1 - 0.9) * g
        v2 = 0.999 * nu[path] + (1 - 0.999) * (g * g)
        upd = lr * (m2 / bc1) / (torch.sqrt(v2 / bc2) + 1e-15)
        if path[0] == "anchors":
            m = active.reshape((-1,) + (1,) * (p.dim() - 1))
            p.copy_(torch.where(m, p - upd, p))
            mu[path].copy_(torch.where(m, m2, mu[path]))
            nu[path].copy_(torch.where(m, v2, nu[path]))
        else:
            p.sub_(upd)
            mu[path].copy_(m2)
            nu[path].copy_(v2)


# --- densification (src/gaussian_model.cpp:1505-1762) ----------------------

def _lexsort(keys):
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


@torch.no_grad()
def densify(st, mc, oc, gen):
    """adjust_anchor: growth on three levels from the offset-gradient
    statistics with random candidate draws, voxel dedup against anchors and
    candidates, then opacity pruning and a stable active-first compaction
    of every per-anchor row (parameters, moments, statistics)."""
    a, stats = st["anchors"], st["stats"]
    cap, k = a["anchor"].shape[0], mc["n_offsets"]
    dev = a["anchor"].device
    keeps = [torch.rand(cap * k, generator=gen, device=dev)
             <= 1.0 - 0.5 ** (lvl + 1) for lvl in range(mc["update_depth"])]
    denom = stats["offset_denom"]
    grads = torch.where(denom == 0, 0.0, stats["offset_grad_accum"]
                        / torch.where(denom == 0, 1.0, denom))
    gnorm = grads.abs().reshape(-1)
    omask = (denom > oc["update_interval"] * oc["success_threshold"] * 0.5
             ).reshape(-1)
    scale3 = torch.exp(a["scaling"][:, :3])
    cand_xyz = (a["anchor"][:, None] + a["offset"] * scale3[:, None]
                ).reshape(-1, 3)
    cand_feat = torch.repeat_interleave(a["feat"], k, 0)
    cand_base = omask & torch.repeat_interleave(a["active"], k)
    anchor_keys = ("anchor", "offset", "feat", "scaling", "rotation",
                   "opacity")
    for lvl, keep_draw in enumerate(keeps):
        thr = oc["densify_grad_threshold"] * (
            math.floor(mc["update_hierachy_factor"] / 2) ** lvl)
        size = mc["voxel_size"] * int(mc["update_init_factor"]
                                      / mc["update_hierachy_factor"] ** lvl)
        cand = cand_base & (gnorm >= thr) & keep_draw
        n_active = int(a["active"].sum())
        cells = torch.cat([to_int32(torch.round(a["anchor"] / size)),
                           to_int32(torch.round(cand_xyz / size))])
        tag = torch.cat([torch.zeros(cap, dtype=torch.int32, device=dev),
                         torch.ones(cap * k, dtype=torch.int32, device=dev)])
        cells = torch.where(torch.cat([a["active"], cand])[:, None], cells,
                            2**30)
        src = _lexsort([cells[:, 0], cells[:, 1], cells[:, 2], tag])
        cs, tg = cells[src], tag[src]
        new_cell = torch.ones(len(src), dtype=torch.bool, device=dev)
        new_cell[1:] = (cs[1:] != cs[:-1]).any(1)
        keep = (tg == 1) & new_cell & (cs[:, 0] < 2**30)
        seg = torch.cumsum(new_cell.long(), 0) - 1
        fdim = cand_feat.shape[1]
        feat_all = torch.cat([torch.full((cap, fdim), -math.inf, device=dev),
                              cand_feat])
        fs = torch.where((tg == 1)[:, None], feat_all[src], -math.inf)
        seg_max = torch.full_like(fs, -math.inf).scatter_reduce(
            0, seg[:, None].expand(-1, fdim), fs, "amax")
        kept_feat = seg_max[seg]
        kept_feat = torch.where(torch.isfinite(kept_feat), kept_feat, 0.0)
        dest = torch.where(keep, n_active + torch.cumsum(keep.int(), 0) - 1,
                           cap)
        sel = dest < cap
        d = dest[sel].long()
        a["anchor"][d] = cs[sel].float() * size
        a["scaling"][d] = math.log(size)
        a["rotation"][d] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        a["opacity"][d] = math.log(0.1 / 0.9)
        a["feat"][d] = kept_feat[sel]
        a["offset"][d] = 0.0
        fresh = torch.zeros(cap, dtype=torch.bool, device=dev)
        fresh[d] = keep[sel]
        a["active"] |= fresh
        for name in anchor_keys:
            for mom in (st["mu"], st["nu"]):
                x = mom[("anchors", name)]
                x.masked_fill_(fresh.reshape((-1,) + (1,) * (x.dim() - 1)),
                               0.0)
        for x in stats.values():
            x.masked_fill_(fresh.reshape((-1,) + (1,) * (x.dim() - 1)), 0.0)
    om = omask.reshape(cap, k)
    stats["offset_denom"].masked_fill_(om, 0.0)
    stats["offset_grad_accum"].masked_fill_(om, 0.0)
    well = stats["anchor_demon"] > oc["update_interval"] * \
        oc["success_threshold"]
    prune = ((stats["opacity_accum"] < oc["min_opacity"]
              * stats["anchor_demon"]) & well & a["active"])
    for name in ("opacity_accum", "anchor_demon"):
        stats[name].masked_fill_(well | prune, 0.0)
    for name in ("offset_denom", "offset_grad_accum"):
        stats[name].masked_fill_(prune[:, None], 0.0)
    new_active = a["active"] & ~prune
    a["scaling"][:, 3:] = torch.clamp(a["scaling"][:, 3:], max=0.05)
    perm = torch.sort((~new_active).int(), stable=True).indices
    for name in anchor_keys:
        a[name] = a[name][perm]
    a["active"] = new_active[perm]
    for name in anchor_keys:
        for mom in (st["mu"], st["nu"]):
            x = mom[("anchors", name)][perm]
            x.masked_fill_((~a["active"]).reshape(
                (-1,) + (1,) * (x.dim() - 1)), 0.0)
            mom[("anchors", name)] = x
    for name in list(stats):
        stats[name] = stats[name][perm]


# --- the mapper's keyframe sampler (src/gaussian_mapper.cpp:1459-1495) ------

class Sampler:
    """The shuffled sliding window with times-of-use budgets."""

    def __init__(self, ids, times_of_use, seed):
        self.rng = random.Random(seed)
        self.remaining = {i: times_of_use for i in ids}
        self.order = list(ids)
        self.rng.shuffle(self.order)
        self.idx = 0

    def next(self):
        start = self.idx
        while True:
            self.idx = (self.idx + 1) % len(self.order)
            if self.idx == start:
                for i in self.remaining:
                    self.remaining[i] += 1
            kid = self.order[self.idx]
            if self.remaining[kid] > 0:
                break
        self.remaining[kid] -= 1
        return kid


# --- the training steps the map cells compare -------------------------------

def train_steps(anchors, dec, stats, cams, gts, kf_ids, start_it, n_steps,
                mc, oc, rc, w, h, seed, times_of_use, precision="f32"):
    """n_steps mapper iterations from `start_it` on copies of the given map,
    decoders and statistics: each samples a keyframe, renders, takes the
    loss, its gradients, the statistics and a masked Adam step, and
    densifies when the iteration is due. Returns (kf ids sampled, losses,
    the gradient leaves of the first step, the final parameters)."""
    dev = anchors["anchor"].device
    a = {n: v.clone() for n, v in anchors.items()}
    d = {n: v.clone() for n, v in dec.items()}
    st = {"anchors": a, "stats": {n: v.clone() for n, v in stats.items()}}
    paths = [("anchors", n) for n in ANCHOR_FIELDS] + \
        [("decoders", n) for n in d]
    st["mu"] = {p: torch.zeros_like(_leaf(st, d, p)) for p in paths}
    st["nu"] = {p: torch.zeros_like(_leaf(st, d, p)) for p in paths}
    sampler = Sampler(kf_ids, times_of_use, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bg = torch.zeros(3, device=dev)
    cap, k = a["anchor"].shape[0], mc["n_offsets"]
    sampled, losses, first = [], [], None
    with matmul_precision(precision):
        for n in range(n_steps):
            it = start_it + n + 1
            kid = sampler.next()
            sampled.append(kid)
            cam = cams[kid]
            leaves = {p: _leaf(st, d, p).detach().requires_grad_()
                      for p in paths}
            an = dict(a, **{p[1]: leaves[p] for p in paths
                            if p[0] == "anchors"})
            dd = {p[1]: leaves[p] for p in paths if p[0] == "decoders"}
            m2d = torch.zeros((cap * k, 2), device=dev, requires_grad=True)
            out = render(an, dd, cam, mc, rc, w, h, bg, precision=precision,
                         mean2d_offset=m2d)
            gt = gts[kid]
            if precision == "half_image":  # the fault: half the rows left out
                out = dict(out, image=out["image"][:, :h // 2])
                gt = gt[:, :h // 2]
            loss = step_loss(out, gt, it, oc)
            gl = torch.autograd.grad(loss, [*leaves.values(), m2d],
                                     allow_unused=True)
            gl = [torch.zeros_like(x) if g is None else
                  torch.where(torch.isfinite(g), g, 0.0)
                  for x, g in zip([*leaves.values(), m2d], gl)]
            grads = dict(zip(paths, gl[:-1]))
            losses.append(float(loss.detach()))
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
                adam(params, grads, st["mu"], st["nu"], n + 1, it, oc,
                     a["active"])
                if (oc["update_from"] < it < oc["update_until"]
                        and it % oc["update_interval"] == 0):
                    densify(st, mc, oc, gen)
                    a = st["anchors"]
    final = {p: _leaf(st, d, p).detach() for p in paths}
    final[("anchors", "active")] = st["anchors"]["active"]
    return sampled, losses, first, final


def _leaf(st, dec, path):
    return st["anchors"][path[1]] if path[0] == "anchors" else dec[path[1]]


# --- the eval render the render cells compare -------------------------------

def calibrate(anchors, dec, cams, mc, rc, w, h, headroom=2.0):
    """The eval tiers sized from the map's own footprints on the
    calibration views (2 x the largest count of footprints over ksmall and
    over kmid, a power of two, between eval floors and compact)."""
    n_mid = n_large = 0
    with torch.no_grad():
        for cam in cams:
            g = decode(anchors, dec, cam, mc, rc, w, h)
            p = project(g["xyz"], cov3d(g["scaling"], g["rotation"]), cam, w,
                        h, rc, g["valid"])
            t = torch.where(p["alive"], torch.clamp(p["touched"], max=rc["kmax"]),
                            0)
            n_mid = max(n_mid, int((t > rc["ksmall"]).sum()))
            n_large = max(n_large, int((t > rc["kmid"]).sum()))

    def pow2(n):
        return 1 << max(0, math.ceil(math.log2(max(n, 1))))

    nmid = min(rc["compact"], max(rc["nmid"], pow2(int(n_mid * headroom))))
    nlarge = min(nmid, max(rc["nlarge"], pow2(int(n_large * headroom))))
    return dict(rc, nmid=nmid, nlarge=nlarge)


def eval_config(rc, w, h):
    """The eval path's binning for a training config: the three-tier
    footprint selection where the grid fits 63 x 31 tiles of 16 px and
    kmax is 6..31 (ksmall 2, kmid kmax / 2, nmid compact / 8 and nlarge
    compact / 32 as floors), else the training binning. Returns (config,
    whether it is the eval selection)."""
    ntx, nty = grid(rc, w, h)
    if rc["tile"] != 16 or ntx > 63 or nty > 31 or not 6 <= rc["kmax"] <= 31:
        return dict(rc), False
    nmid = rc["compact"] // 8
    nlarge = min(nmid, max(rc["nlarge"] if rc["ksmall"] else 0,
                           rc["compact"] // 32))
    return dict(rc, ksmall=2, kmid=rc["kmax"] // 2, nmid=nmid,
                nlarge=nlarge), True


@torch.no_grad()
def eval_image(anchors, dec, cam, mc, rc, w, h, eval_path, precision="f32"):
    with matmul_precision(precision):
        return render(anchors, dec, cam, mc, rc, w, h,
                      torch.zeros(3, device=anchors["anchor"].device),
                      eval_path=eval_path, precision=precision)["image"]
