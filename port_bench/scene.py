"""The cells' inputs, made on the device from the seed with plain torch.

Frozen copies, adapted to a device generator, of the repo's synthetic room
(`utils/synthetic.py`): its trajectory, its seeded map's anchors and
decoders; the keyframes' RGB and depth, ray-cast from the same room (a
4 x 3 x 6 m box whose walls carry `make_room_scene`'s colour ramps) with a
seeded texture; and the anchors placed on the walls where the keyframes see
them, so that the map matches the images. No input is made by the program
under test. Everything
here depends only on (config, seed): the same seed gives the same inputs,
and every seed gives the same sizes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BOX_LO = (-2.0, -1.5, 0.0)
BOX_HI = (2.0, 1.5, 6.0)


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A torch.Generator on `device` for one named use of the seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) % (1 << 63))


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a rotation matrix, w >= 0 (Shepperd's method)."""
    m = np.asarray(R, np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
             (m[1, 0] - m[0, 1]) / s]
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s,
             (m[0, 2] + m[2, 0]) / s]
    elif m[1, 1] > m[2, 2]:
        s = math.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s,
             (m[1, 2] + m[2, 1]) / s]
    else:
        s = math.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
             (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    q = np.array(q)
    return q if q[0] >= 0 else -q


def quat_to_rotmat(q) -> np.ndarray:
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def trajectory(n_views: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """`make_trajectory`'s world-to-camera (quat wxyz, trans) poses: jittered
    positions near the room's opening, looking into it."""
    poses = []
    for i in range(n_views):
        f = i / max(n_views - 1, 1)
        center = np.array([
            -1.0 + 2.0 * f + 0.05 * np.sin(11 * f * np.pi),
            0.2 * np.sin(3 * f * np.pi),
            0.3 + 0.2 * (1 - np.cos(5 * f * np.pi)),
        ])
        look = np.array([0.0, 0.0, 4.5]) - center
        look /= np.linalg.norm(look)
        right = np.cross(np.array([0.0, 1.0, 0.0]), look)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(look, right), look], axis=0)
        poses.append((rotmat_to_quat(R), -R @ center))
    return poses


def _projection(znear, zfar, tan_x, tan_y) -> np.ndarray:
    """The OpenGL-style perspective matrix of the reference's keyframes
    (src/gaussian_keyframe.cpp:252-279), column-vector form."""
    top, right = tan_y * znear, tan_x * znear
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = 2.0 * znear / (right + right)
    P[1, 1] = 2.0 * znear / (top + top)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def camera_inputs(poses, cam: dict, device) -> dict:
    """The render inputs of every pose, stacked on `device`: the keys of
    the port's `Keyframe.render_inputs()` with a leading pose axis,
    computed by the reference's formulas (W2C^T, P^T, their product, the
    camera centre, pose7 = (t, q), tan of the half fields of view)."""
    w, h = cam["width"], cam["height"]
    tan_x = math.tan(2.0 * math.atan(w / (2.0 * cam["fx"])) * 0.5)
    tan_y = math.tan(2.0 * math.atan(h / (2.0 * cam["fy"])) * 0.5)
    proj = _projection(0.01, 100.0, tan_x, tan_y).T.astype(np.float32)
    out = {k: [] for k in ("world_view_transform", "full_proj_transform",
                           "camera_center", "pose7", "projection_matrix")}
    for q, t in poses:
        rt = np.eye(4)
        rt[:3, :3] = quat_to_rotmat(q)
        rt[:3, 3] = t
        w2c = np.linalg.inv(np.linalg.inv(rt)).astype(np.float32)
        wvt = w2c.T.astype(np.float32)
        out["world_view_transform"].append(wvt)
        out["full_proj_transform"].append((wvt @ proj).astype(np.float32))
        out["camera_center"].append(
            np.linalg.inv(wvt)[3, :3].astype(np.float32))
        out["pose7"].append(np.concatenate([t, q]).astype(np.float32))
        out["projection_matrix"].append(proj)
    stacked = {k: torch.as_tensor(np.stack(v), device=device)
               for k, v in out.items()}
    n = len(poses)
    stacked["tan_fovx"] = torch.full((n,), np.float32(tan_x), device=device)
    stacked["tan_fovy"] = torch.full((n,), np.float32(tan_y), device=device)
    return stacked


def view(cams: dict, i: int) -> dict:
    """Pose i's render inputs (views into the stacked tensors)."""
    return {k: v[i] for k, v in cams.items()}


def _wall_colour(face, u, v):
    """`make_room_scene`'s colour ramp of each face at face coordinates
    (u, v) in [0, 1]: back, floor, ceiling, left, right."""
    one = torch.ones_like(u)
    ramps = [
        (0.8 * u, 0.3 * one, 0.8 * v),
        (0.2 * one, 0.7 * u, 0.4 * v),
        (0.9 * one, 0.8 * one, 0.6 * u),
        (0.5 + 0.5 * v, 0.2 + 0.5 * u, 0.1 * one),
        (0.1 * one, 0.4 + 0.4 * u, 0.6 + 0.4 * v),
    ]
    rgb = torch.zeros((3,) + u.shape, device=u.device)
    for i, ramp in enumerate(ramps):
        sel = face == i
        for c in range(3):
            rgb[c] = torch.where(sel, ramp[c], rgb[c])
    return rgb


def _first_hit(o: torch.Tensor, d: torch.Tensor):
    """(distance along d, face, point) of each ray's first wall of the room:
    o and d broadcast to [..., 3]; d's camera z is 1, so the distance is the
    depth. The faces are back, floor, ceiling, left, right; the opening at
    z = 0 is none."""
    lo = torch.tensor(BOX_LO, device=d.device)
    hi = torch.tensor(BOX_HI, device=d.device)
    cands = []
    for axis, plane in ((2, hi[2]), (1, hi[1]), (1, lo[1]), (0, lo[0]),
                        (0, hi[0])):
        s = (plane - o[..., axis]) / d[..., axis]
        cands.append(torch.where(s > 1e-6, s, torch.inf))
    s_hit, face = torch.stack(cands, -1).min(-1)
    return s_hit, face, o + s_hit[..., None] * d


def _pose_tensors(poses, device):
    """(R [n, 3, 3], t [n, 3]) of world-to-camera poses on `device`."""
    R = torch.as_tensor(np.stack([quat_to_rotmat(q) for q, _ in poses]),
                        dtype=torch.float32, device=device)
    t = torch.as_tensor(np.stack([t for _, t in poses]),
                        dtype=torch.float32, device=device)
    return R, t


def keyframe_images(poses, cam: dict, seed: int, device,
                    batch: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """(rgb [n, 3, H, W], depth [n, H, W]) float32 on the host: each pose's
    ray-cast of the room, coloured by the walls' ramps times a seeded
    texture (8 plane waves), never black, with the hit's camera z as
    depth."""
    w, h = cam["width"], cam["height"]
    g = generator(seed, device, 1)
    freqs = torch.rand((8, 3), generator=g, device=device) * 12.0 + 2.0
    phases = torch.rand((8,), generator=g, device=device) * 2 * math.pi
    amps = torch.rand((8,), generator=g, device=device) * 0.06
    ys, xs = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                            torch.arange(w, device=device, dtype=torch.float32),
                            indexing="ij")
    d_cam = torch.stack([(xs - cam["cx"]) / cam["fx"],
                         (ys - cam["cy"]) / cam["fy"],
                         torch.ones_like(xs)], -1)  # [H, W, 3], z = 1
    lo = torch.tensor(BOX_LO, device=device)
    hi = torch.tensor(BOX_HI, device=device)
    rgbs = np.empty((len(poses), 3, h, w), np.float32)
    depths = np.empty((len(poses), h, w), np.float32)
    for b0 in range(0, len(poses), batch):
        chunk = poses[b0:b0 + batch]
        R, t = _pose_tensors(chunk, device)
        c = -torch.einsum("bji,bj->bi", R, t)  # camera centres
        d = torch.einsum("bji,hwj->bhwi", R, d_cam)  # world directions
        s_hit, face, p = _first_hit(c[:, None, None, :], d)
        q = (p - lo) / (hi - lo)
        u = torch.where(face <= 2, q[..., 0], q[..., 1]).clamp(0, 1)
        v = torch.where(face == 0, q[..., 1], q[..., 2]).clamp(0, 1)
        rgb = _wall_colour(face, u, v)  # [3, b, H, W]
        wave = torch.sin(torch.einsum("bhwi,ki->bhwk", p, freqs) + phases)
        tex = 1.0 + (wave * amps).sum(-1)
        rgb = (rgb * tex).clamp(0.02, 1.0)
        rgbs[b0:b0 + len(chunk)] = rgb.permute(1, 0, 2, 3).cpu().numpy()
        depths[b0:b0 + len(chunk)] = s_hit.cpu().numpy()
    return rgbs, depths


def surface_points(poses, cam: dict, n: int, seed: int, device
                   ) -> torch.Tensor:
    """n points [n, 3] on the room's walls where the poses see them: the
    first hit of the ray through a seeded pixel of a seeded pose, as the
    mapper places anchors on back-projected keyframe depth."""
    g = generator(seed, device, 5)
    R, t = _pose_tensors(poses, device)
    i = torch.randint(0, len(poses), (n,), generator=g, device=device)
    px = torch.rand((n,), generator=g, device=device) * cam["width"]
    py = torch.rand((n,), generator=g, device=device) * cam["height"]
    d_cam = torch.stack([(px - cam["cx"]) / cam["fx"],
                         (py - cam["cy"]) / cam["fy"],
                         torch.ones_like(px)], -1)
    d = torch.einsum("nji,nj->ni", R[i], d_cam)
    c = -torch.einsum("nji,nj->ni", R[i], t[i])
    return _first_hit(c, d)[2]


def seeded_map(mc: dict, n_active: int, points: torch.Tensor, seed: int,
               device) -> dict:
    """`seeded_map`'s anchors at the widths of the model config `mc`,
    drawn on `device` at `points` (one a slot): offsets N(0, 0.3),
    features N(0, 0.1), log-scales log(0.05), identity rotations, opacity
    logit(0.1), the first n_active active."""
    cap, k, f = mc["capacity"], mc["n_offsets"], mc["feat_dim"]
    g = generator(seed, device, 2)
    rot = torch.zeros((cap, 4), device=device)
    rot[:, 0] = 1.0
    return {
        "anchor": points.clone(),
        "offset": 0.3 * torch.randn((cap, k, 3), generator=g, device=device),
        "feat": 0.1 * torch.randn((cap, f), generator=g, device=device),
        "scaling": torch.full((cap, 6), math.log(0.05), device=device),
        "rotation": rot,
        "opacity": torch.full((cap, 1), math.log(0.1 / 0.9), device=device),
        "active": torch.arange(cap, device=device) < n_active,
    }


def decoder_shapes(mc: dict) -> dict:
    """Each decoder parameter's shape, by the port's parameter names (the
    reference's nn::Sequential stacks, src/gaussian_model.cpp:62-98)."""
    f, k, a = mc["feat_dim"], mc["n_offsets"], mc["appearance_dim"]
    d_in = f + 3
    shapes = {}
    for name, n_in, n_out in (("opacity", d_in, k), ("cov", d_in, 7 * k),
                              ("color", d_in + a, 3 * k)):
        shapes[f"{name}.l1.weight"] = (f, n_in)
        shapes[f"{name}.l1.bias"] = (f,)
        shapes[f"{name}.l2.weight"] = (n_out, f)
        shapes[f"{name}.l2.bias"] = (n_out,)
    if a > 0:
        shapes["appearance.weight"] = (a, 7)
        shapes["appearance.bias"] = (a,)
        shapes["embedding.table"] = (mc["embedding_dim"], a)
    return shapes


def seeded_decoders(mc: dict, seed: int, device) -> dict:
    """Decoder weights U(+-1/sqrt(fan_in)) (nn.Linear's initialisation) and
    the unused embedding table N(0, 1), by parameter name."""
    g = generator(seed, device, 3)
    shapes = decoder_shapes(mc)
    out = {}
    for name, shape in shapes.items():
        if name == "embedding.table":
            out[name] = torch.randn(shape, generator=g, device=device)
            continue
        fan_in = shapes[name.rsplit(".", 1)[0] + ".weight"][1]
        b = 1.0 / math.sqrt(fan_in)
        out[name] = (torch.rand(shape, generator=g, device=device) * 2 - 1) * b
    return out


def set_alive_share(dec: dict, anchors: dict, centre: torch.Tensor,
                    share: float, opacity: float) -> None:
    """Scales the opacity decoder's output layer and sets its biases so
    that each offset is alive (its decoded opacity above 0) at `share` of
    the active anchors, seen from `centre`, and the median alive offset's
    opacity is `opacity`: a trained map keeps part of its offsets, and
    those it keeps are opaque. The same share on every seed gives every
    seed the same work."""
    act = anchors["active"]
    ob = anchors["anchor"][act] - centre
    ob = ob / torch.linalg.norm(ob, dim=-1, keepdim=True)
    local = torch.cat([anchors["feat"][act], ob], -1)
    hidden = torch.relu(local @ dec["opacity.l1.weight"].T
                        + dec["opacity.l1.bias"])
    pre = hidden @ dec["opacity.l2.weight"].T  # [n_active, n_offsets]
    q = torch.quantile(pre, torch.tensor([1.0 - share, 1.0 - share / 2],
                                         device=pre.device), dim=0)
    gain = math.atanh(opacity) / (q[1] - q[0])
    dec["opacity.l2.weight"] = dec["opacity.l2.weight"] * gain[:, None]
    dec["opacity.l2.bias"] = -q[0] * gain


def seeded_scene(cfg: dict, kf_poses, seed: int, device
                 ) -> tuple[dict, dict]:
    """(anchors, decoders) of a configuration from the seed: the map on the
    surfaces the keyframes see, the decoders with the configuration's
    share of alive offsets at the keyframes' mean centre."""
    mc, m = cfg["model"], cfg["map"]
    points = surface_points(kf_poses, cfg["camera"], mc["capacity"], seed,
                            device)
    anchors = seeded_map(mc, m["n_active"], points, seed, device)
    dec = seeded_decoders(mc, seed, device)
    centre = torch.as_tensor(np.mean([-quat_to_rotmat(q).T @ t
                                      for q, t in kf_poses], 0),
                             dtype=torch.float32, device=device)
    set_alive_share(dec, anchors, centre, m["alive_share"],
                    m["alive_opacity"])
    return anchors, dec


def seeded_stats(mc: dict, active: torch.Tensor, stats_cfg: dict, seed: int,
                 device) -> dict:
    """Densification statistics as a run resumed `since` iterations after
    its last adjust holds them: anchor_demon (visible iterations) uniform
    in [demon_lo, since], opacity_accum = demon x U(opacity_lo,
    opacity_hi), offset_denom = demon x U(denom_lo, 1) and
    offset_grad_accum = denom x |N(0, grad_sigma)|, zero on inactive
    slots."""
    cap, k = mc["capacity"], mc["n_offsets"]
    g = generator(seed, device, 4)
    act = active.float()
    since, lo = stats_cfg["since"], stats_cfg["demon_lo"]
    demon = torch.randint(lo, since + 1, (cap,), generator=g,
                          device=device).float() * act
    o_lo, o_hi = stats_cfg["opacity_lo"], stats_cfg["opacity_hi"]
    opac = demon * (o_lo + (o_hi - o_lo) * torch.rand(
        (cap,), generator=g, device=device))
    d_lo = stats_cfg["denom_lo"]
    denom = torch.floor(demon[:, None] * (d_lo + (1 - d_lo) * torch.rand(
        (cap, k), generator=g, device=device)))
    grad = denom * stats_cfg["grad_sigma"] * torch.randn(
        (cap, k), generator=g, device=device).abs()
    return {"opacity_accum": opac, "anchor_demon": demon,
            "offset_grad_accum": grad, "offset_denom": denom}


def nerfpp_radius(poses) -> float:
    """getNerfppNorm's radius over the camera centres (1.1 x the largest
    distance from their mean, src/gaussian_scene.cpp:113-149)."""
    centres = np.stack([-quat_to_rotmat(q).T @ t for q, t in poses])
    return float(np.linalg.norm(centres - centres.mean(0), axis=1).max()
                 * 1.1)
