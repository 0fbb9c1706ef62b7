"""The inputs of an unbounded 360-degree scene, made on the device from the
seed with plain torch: an orbit of cameras around a central object, in the
manner of the Mip-NeRF 360 captures.

The scene: a sphere on a ground disc (the object a capture circles), the
disc, and a background shell around both (the far surroundings), each with
its own colour ramp times a seeded texture. World "up" is -y, so that the
cameras' image rows run down as in the keyframes of `scene.py`. The cameras
circle the object at a radius and height drawn from the seed, each looking
at the object's centre, so every view holds the object, the ground from
near the camera to its edge, and the shell behind. Keyframe images are
ray-cast (no depth: an offline capture has none); the anchors are placed
where the ray through a seeded pixel of a seeded keyframe first hits, as a
sparse reconstruction places points, with a scale that grows with the
distance from the object (the configuration's `anchor_scale` up to 2 m
away, in proportion beyond) and spreads log-normally about it (its log's
deviation `anchor_scale_sigma`). The decoders, the alive share and the
densification statistics are `scene.py`'s. Everything here depends only on
(config, seed), and every seed gives the same sizes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench import scene

OBJECT_CENTRE = (0.0, -0.7, 0.0)
OBJECT_RADIUS = 0.7
GROUND_RADIUS = 10.0
SHELL_RADIUS = 14.0


def trajectory(n_views: int, seed: int) -> list[tuple[np.ndarray,
                                                        np.ndarray]]:
    """World-to-camera (quat wxyz, trans) poses of an orbit: radius 3.2-4.0
    and height 1.2-1.8 drawn from the seed, each wobbling by a tenth around
    the circle, every camera looking at the object's centre."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    r0, h0 = rng.uniform(3.2, 4.0), rng.uniform(1.2, 1.8)
    phase = rng.uniform(0.0, 2.0 * np.pi, 2)
    target = np.array(OBJECT_CENTRE)
    up = np.array([0.0, -1.0, 0.0])
    poses = []
    for i in range(n_views):
        a = 2.0 * np.pi * i / n_views
        r = r0 * (1.0 + 0.1 * np.sin(3.0 * a + phase[0]))
        hgt = h0 * (1.0 + 0.1 * np.sin(2.0 * a + phase[1]))
        centre = np.array([r * np.cos(a), -hgt, r * np.sin(a)])
        look = target - centre
        look /= np.linalg.norm(look)
        right = np.cross(look, up)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(look, right), look], axis=0)
        poses.append((scene.rotmat_to_quat(R), -R @ centre))
    return poses


def first_hit(o: torch.Tensor, d: torch.Tensor):
    """(distance along d, surface, point) of each ray's first surface: o
    and d broadcast to [..., 3]; d's camera z is 1, so the distance is the
    depth. Surfaces: 0 the object, 1 the ground disc, 2 the shell (every
    ray from inside it hits it)."""
    c = torch.tensor(OBJECT_CENTRE, device=d.device)
    dd = (d * d).sum(-1)

    def sphere(centre, radius, far):
        oc = o - centre
        b = (oc * d).sum(-1)
        disc = b * b - dd * ((oc * oc).sum(-1) - radius * radius)
        root = torch.sqrt(torch.clamp(disc, min=0.0))
        s = ((-b + root) if far else (-b - root)) / dd
        return torch.where((disc >= 0) & (s > 1e-6), s, torch.inf)

    s_obj = sphere(c, OBJECT_RADIUS, False)
    s_gnd = -o[..., 1] / d[..., 1]
    hit = o + s_gnd[..., None] * d
    in_disc = (hit[..., 0] ** 2 + hit[..., 2] ** 2) <= GROUND_RADIUS ** 2
    s_gnd = torch.where((s_gnd > 1e-6) & in_disc, s_gnd, torch.inf)
    s_shell = sphere(torch.zeros(3, device=d.device), SHELL_RADIUS, True)
    s_hit, surface = torch.stack([s_obj, s_gnd, s_shell], -1).min(-1)
    return s_hit, surface, o + s_hit[..., None] * d


def _colour(surface, p):
    """Each surface's colour ramp at the hit points p [..., 3]: the object
    by azimuth and height, the ground by radius and azimuth, the shell by
    elevation and azimuth."""
    az = torch.atan2(p[..., 2], p[..., 0]) / (2 * math.pi) + 0.5
    rad = torch.sqrt(p[..., 0] ** 2 + p[..., 2] ** 2)
    one = torch.ones_like(az)
    h_obj = (-p[..., 1] / (2 * OBJECT_RADIUS)).clamp(0, 1)
    g = (rad / GROUND_RADIUS).clamp(0, 1)
    elev = (-p[..., 1] / SHELL_RADIUS).clamp(-1, 1) * 0.5 + 0.5
    ramps = [
        (0.7 + 0.3 * az, 0.3 + 0.4 * h_obj, 0.2 * one),
        (0.25 + 0.2 * g, 0.45 + 0.2 * az, 0.15 + 0.1 * g),
        (0.3 + 0.4 * elev, 0.5 + 0.3 * elev, 0.4 + 0.5 * az * elev),
    ]
    rgb = torch.zeros((3,) + az.shape, device=az.device)
    for i, ramp in enumerate(ramps):
        sel = surface == i
        for ch in range(3):
            rgb[ch] = torch.where(sel, ramp[ch], rgb[ch])
    return rgb


def keyframe_images(poses, cam: dict, seed: int, device,
                    batch: int = 8) -> np.ndarray:
    """rgb [n, 3, H, W] float32 on the host: each pose's ray-cast of the
    scene, its surfaces' ramps times a seeded texture (8 plane waves),
    never black."""
    w, h = cam["width"], cam["height"]
    g = scene.generator(seed, device, 11)
    freqs = torch.rand((8, 3), generator=g, device=device) * 6.0 + 1.0
    phases = torch.rand((8,), generator=g, device=device) * 2 * math.pi
    amps = torch.rand((8,), generator=g, device=device) * 0.08
    ys, xs = torch.meshgrid(torch.arange(h, device=device,
                                         dtype=torch.float32),
                            torch.arange(w, device=device,
                                         dtype=torch.float32), indexing="ij")
    d_cam = torch.stack([(xs - cam["cx"]) / cam["fx"],
                         (ys - cam["cy"]) / cam["fy"],
                         torch.ones_like(xs)], -1)  # [H, W, 3], z = 1
    rgbs = np.empty((len(poses), 3, h, w), np.float32)
    for b0 in range(0, len(poses), batch):
        chunk = poses[b0:b0 + batch]
        R, t = scene._pose_tensors(chunk, device)
        c = -torch.einsum("bji,bj->bi", R, t)  # camera centres
        d = torch.einsum("bji,hwj->bhwi", R, d_cam)  # world directions
        _, surface, p = first_hit(c[:, None, None, :], d)
        rgb = _colour(surface, p)  # [3, b, H, W]
        wave = torch.sin(torch.einsum("bhwi,ki->bhwk", p, freqs) + phases)
        rgb = (rgb * (1.0 + (wave * amps).sum(-1))).clamp(0.02, 1.0)
        rgbs[b0:b0 + len(chunk)] = rgb.permute(1, 0, 2, 3).cpu().numpy()
    return rgbs


def surface_points(poses, cam: dict, n: int, seed: int, device
                   ) -> torch.Tensor:
    """n points [n, 3] on the surfaces where the poses see them: the first
    hit of the ray through a seeded pixel of a seeded pose."""
    g = scene.generator(seed, device, 12)
    R, t = scene._pose_tensors(poses, device)
    i = torch.randint(0, len(poses), (n,), generator=g, device=device)
    px = torch.rand((n,), generator=g, device=device) * cam["width"]
    py = torch.rand((n,), generator=g, device=device) * cam["height"]
    d_cam = torch.stack([(px - cam["cx"]) / cam["fx"],
                         (py - cam["cy"]) / cam["fy"],
                         torch.ones_like(px)], -1)
    d = torch.einsum("nji,nj->ni", R[i], d_cam)
    c = -torch.einsum("nji,nj->ni", R[i], t[i])
    return first_hit(c, d)[2]


def seeded_scene(cfg: dict, kf_poses, seed: int, device
                 ) -> tuple[dict, dict]:
    """(anchors, decoders) from the seed: the map on the surfaces the
    keyframes see, the decoders with the configuration's share of alive
    offsets seen from the object's centre."""
    mc, m = cfg["model"], cfg["map"]
    points = surface_points(kf_poses, cfg["camera"], mc["capacity"], seed,
                            device)
    anchors = scene.seeded_map(mc, m["n_active"], points, seed, device)
    # an anchor's scale grows with its distance from the object, as a
    # reconstruction's point spacing grows away from the capture, and
    # spreads log-normally about that, as a trained map's does (large
    # anchors cover smooth regions)
    far = torch.linalg.norm(points - torch.tensor(OBJECT_CENTRE,
                                                  device=device), dim=-1)
    spread = m["anchor_scale_sigma"] * torch.randn(
        points.shape[0], generator=scene.generator(seed, device, 13),
        device=device)
    anchors["scaling"] = (torch.log(m["anchor_scale"] * torch.clamp(
        far / 2.0, min=1.0)) + spread)[:, None].expand(-1, 6).contiguous()
    dec = scene.seeded_decoders(mc, seed, device)
    scene.set_alive_share(dec, anchors,
                          torch.tensor(OBJECT_CENTRE, device=device),
                          m["alive_share"], m["alive_opacity"])
    return anchors, dec
