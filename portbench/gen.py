"""Traffic generator: synthetic LiDAR drives made from a seed.

A frozen adaptation of `chip_smoke.etl_static_scene` (a street scene of
building walls and poles, a sensor 1.73 m above the ground) and of
`chip_smoke.drive_scene` (objects moving at a constant velocity), written
in torch so that a drive is made in a few large calls on the device that
will use it. A traffic file (`portbench/traffic/*.json`) holds only the
parameters read here.

Every drive of one traffic mix has the same set of cloud sizes whatever
the seed: the valid-point counts are a fixed even spread over the mix's
range, and the seed only orders them. So a seed changes what the points
are, not how much work they make.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

SENSOR_HEIGHT_M = 1.73
GROUND_Z_M = -SENSOR_HEIGHT_M
# static points end 0.92 m above the sensor, under the pillars' 1 m
MAX_HEIGHT_M = 2.6


@dataclass
class Drive:
    """`n_frames` consecutive frames of one drive, in the sensor frame.

    points [T, n_max, 4] (x, y, z, intensity), valid [T, n_max] (the first
    `counts[t]` rows), ground [T, n_max] (rows on the ground plane),
    ego_x [T] (the sensor's travel along x, m), and the objects: centers
    [T, K, 3], dims [K, 3], yaw [K] (heading, constant), speed [K] (m/s),
    their surface points in box coordinates [K, 400, 4], of which the
    first obj_points [K] are the object's."""

    points: torch.Tensor
    valid: torch.Tensor
    ground: torch.Tensor
    counts: torch.Tensor
    ego_x: torch.Tensor
    obj_centers: torch.Tensor
    obj_dims: torch.Tensor
    obj_yaw: torch.Tensor
    obj_speed: torch.Tensor
    obj_points: torch.Tensor
    obj_local: torch.Tensor


def spread_counts(lo: int, hi: int, n: int, gen: torch.Generator,
                  device) -> torch.Tensor:
    """n whole counts evenly spread over [lo, hi], in an order drawn from
    `gen`."""
    base = torch.linspace(float(lo), float(hi), n, dtype=torch.float64)
    order = torch.randperm(n, generator=gen, device=gen.device).cpu()
    return base.round().long()[order].to(device)


def objects_per_drive(lo: int, hi: int, n: int, seed: int) -> list:
    """The number of objects of each of n drives: an even spread over
    [lo, hi] that every seed shares, in the seed's order."""
    gen = torch.Generator().manual_seed(int(seed) % (2**63 - 1))
    base = torch.linspace(float(lo), float(hi), n).round().long()
    return base[torch.randperm(n, generator=gen)].tolist()


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def static_scene(layout_seed: int, gen: torch.Generator, n: int,
                 x_lo: float, x_hi: float, half_y: float, device):
    """`n` static points [n, 4] above the ground and below the pillars'
    ceiling (1 m over the sensor): 55% on the walls of 24 buildings beside
    the road, 25% on 200 poles off the road, 20% clutter (vegetation) 8 m
    or more off the road's axis, so the road stays free. As
    `chip_smoke.etl_static_scene`, without the ground, which
    `ground_points` makes. The street's layout (buildings, pole sites)
    comes from `layout_seed`, which the traffic mix fixes, so the free
    space a paste needs is the same for every seed; `gen` draws the
    points on it."""
    n_walls, n_poles = (11 * n) // 20, n // 4
    n_clut = n - n_walls - n_poles
    nb = 24
    lay = torch.Generator().manual_seed(int(layout_seed))
    cpu = torch.device("cpu")
    cx = _uniform(lay, (nb,), x_lo + 8, x_hi - 8, cpu)
    side = torch.where(torch.rand(nb, generator=lay) < 0.5, -1.0, 1.0)
    length = _uniform(lay, (nb,), 6, 20, cpu)
    width = _uniform(lay, (nb,), 6, 14, cpu)
    height = _uniform(lay, (nb,), 3, 10, cpu)
    # facing the road within 0.15 rad, the nearest wall 12 m or more off
    # its axis: the road stays free
    cy = side * (12 + 0.5 * width + _uniform(lay, (nb,), 0, half_y - 26,
                                             cpu))
    yaw = _uniform(lay, (nb,), -0.15, 0.15, cpu)
    n_pole_sites = 200
    px = _uniform(lay, (n_pole_sites,), x_lo, x_hi, cpu)
    py = torch.where(torch.rand(n_pole_sites, generator=lay) < 0.5, -1.0,
                     1.0) * _uniform(lay, (n_pole_sites,), 5, half_y, cpu)
    cx, length, width, height, cy, yaw, px, py = (
        t.to(device) for t in (cx, length, width, height, cy, yaw, px, py))
    b = torch.randint(0, nb, (n_walls,), generator=gen, device=device)
    face = torch.randint(0, 4, (n_walls,), generator=gen, device=device)
    u = _uniform(gen, (n_walls,), -0.5, 0.5, device)
    half_sign = torch.where(face % 2 == 0, 0.5, -0.5)
    lx = torch.where(face < 2, u * length[b], half_sign * length[b])
    ly = torch.where(face < 2, half_sign * width[b], u * width[b])
    c, s = torch.cos(yaw[b]), torch.sin(yaw[b])
    walls = torch.stack([
        cx[b] + c * lx - s * ly, cy[b] + s * lx + c * ly,
        GROUND_Z_M + 0.05 + torch.rand(n_walls, generator=gen,
                                       device=device)
        * height[b].clamp(max=MAX_HEIGHT_M)], -1)
    k = torch.randint(0, n_pole_sites, (n_poles,), generator=gen,
                      device=device)
    a = _uniform(gen, (n_poles,), 0, 2 * math.pi, device)
    poles = torch.stack([
        px[k] + 0.15 * torch.cos(a), py[k] + 0.15 * torch.sin(a),
        GROUND_Z_M + 0.05 + torch.rand(n_poles, generator=gen,
                                       device=device) * MAX_HEIGHT_M], -1)
    side = torch.where(torch.rand(n_clut, generator=gen, device=device)
                       < 0.5, -1.0, 1.0)
    clutter = torch.stack([
        _uniform(gen, (n_clut,), x_lo, x_hi, device),
        side * _uniform(gen, (n_clut,), 8.0, half_y, device),
        GROUND_Z_M + 0.05 + torch.rand(n_clut, generator=gen,
                                       device=device) * MAX_HEIGHT_M], -1)
    xyz = torch.cat([walls, poles, clutter])
    inten = torch.rand(n, 1, generator=gen, device=device)
    return torch.cat([xyz, inten], -1)


def box_surface_points(gen, dims: torch.Tensor, n_max: int, device):
    """[K, n_max, 4] points on the sides and roof of boxes of `dims` [K, 3]
    in box coordinates (z from the box's bottom at -h/2), intensity in
    the last column."""
    k = dims.shape[0]
    face = torch.randint(0, 5, (k, n_max), generator=gen, device=device)
    u = torch.rand(k, n_max, generator=gen, device=device) - 0.5
    v = torch.rand(k, n_max, generator=gen, device=device) - 0.5
    l, w, h = (dims[:, i:i + 1] for i in range(3))
    sgn = torch.where(face % 2 == 0, 0.5, -0.5)
    x = torch.where(face < 2, sgn * l, u * l)
    y = torch.where(face < 2, u * w, torch.where(face < 4, sgn * w, v * w))
    z = torch.where(face < 4, v * h, 0.5 * h.expand_as(v))
    inten = torch.rand(k, n_max, generator=gen, device=device)
    return torch.stack([x, y, z, inten], -1)


def spread(lo: float, hi: float, n: int, gen: torch.Generator, device):
    """n values evenly spread over [lo, hi], in an order drawn from `gen`."""
    base = torch.linspace(float(lo), float(hi), n, device=device)
    return base[torch.randperm(n, generator=gen, device=device)]


def make_drive(seed: int, *, n_frames: int, n_max: int, point_range,
               n_objects: int, speed_range_mps, ego_speed_mps: float,
               scene_seed: int, crop_half_m: float = 50.0,
               ground_points: int = 0, hz: float = 10.0,
               device="cpu") -> Drive:
    """One drive of `n_frames` frames at `hz`: a static street scene (its
    layout from `scene_seed`) that the sensor passes at `ego_speed_mps`
    along x, and `n_objects` boxes
    moving at `speed_range_mps` with a constant heading. Each frame holds
    counts[t] valid points after the crop to +-`crop_half_m` and ground
    removal (objects first, then static points drawn from those in the
    crop), then, with `ground_points`, that many ground-plane points marked
    in `ground` (the cloud before ground removal), padded with zeros to
    n_max. The objects' sizes, speeds, distances and point counts are even
    spreads that every seed shares; the seed orders them and draws their
    headings and bearings."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (2**63 - 1))
    dt = 1.0 / hz
    travel = ego_speed_mps * dt * (n_frames - 1)
    counts = spread_counts(point_range[0], point_range[1], n_frames, gen, dev)
    k = int(n_objects)
    # four times the most a frame needs inside the crop, over the whole
    # stretch of road the drive passes
    n_static = int(4 * point_range[1] * (1 + travel / (2 * crop_half_m)))
    scene = static_scene(scene_seed, gen, n_static, -crop_half_m,
                         crop_half_m + travel, crop_half_m, dev)
    dims = torch.stack([spread(3.5, 5.0, k, gen, dev),
                        spread(1.6, 2.0, k, gen, dev),
                        spread(1.4, 1.8, k, gen, dev)], -1)
    yaw = _uniform(gen, (k,), -math.pi, math.pi, dev)
    speed = spread(speed_range_mps[0], speed_range_mps[1], k, gen, dev)
    radius = spread(8.0, 0.6 * crop_half_m, k, gen, dev)
    bearing = _uniform(gen, (k,), -math.pi, math.pi, dev)
    start = torch.stack([0.5 * travel + radius * torch.cos(bearing),
                         radius * torch.sin(bearing),
                         GROUND_Z_M + 0.5 * dims[:, 2]], -1)
    obj_n = spread(100, 400, k, gen, dev).round().long()
    local = box_surface_points(gen, dims, 400, dev)
    t = torch.arange(n_frames, device=dev, dtype=torch.float32) * dt
    vel = torch.stack([speed * torch.cos(yaw), speed * torch.sin(yaw),
                       torch.zeros_like(speed)], -1)
    ego_x = ego_speed_mps * t
    ego = torch.stack([ego_x, torch.zeros_like(t), torch.zeros_like(t)], -1)
    centers = start[None] + t[:, None, None] * vel[None] - ego[:, None]

    c, s = torch.cos(yaw), torch.sin(yaw)
    lx, ly = local[..., 0], local[..., 1]
    obj_rel = torch.stack([c[:, None] * lx - s[:, None] * ly,
                           s[:, None] * lx + c[:, None] * ly,
                           local[..., 2]], -1)  # [K, 400, 3]
    slot = torch.arange(400, device=dev)
    obj_keep = slot[None] < obj_n[:, None]  # [K, 400]

    pts = torch.zeros(n_frames, n_max, 4, device=dev)
    valid = torch.zeros(n_frames, n_max, dtype=torch.bool, device=dev)
    ground = torch.zeros(n_frames, n_max, dtype=torch.bool, device=dev)
    for f in range(n_frames):
        o = obj_rel + centers[f][:, None]
        o = torch.cat([o, local[..., 3:4]], -1)
        in_crop = (o[..., :2].abs() < crop_half_m).all(-1) & obj_keep
        # objects take at most a quarter of a frame (small test clouds)
        o = o[in_crop][: int(counts[f]) // 4]
        st = scene.clone()
        st[:, 0] -= ego_x[f]
        ok = (st[:, :2].abs() < crop_half_m).all(-1)
        need = int(counts[f]) - o.shape[0]
        rank = torch.rand(st.shape[0], generator=gen, device=dev)
        rank = torch.where(ok, rank, 2.0)
        chosen = st[torch.topk(rank, need, largest=False).indices]
        cloud = torch.cat([o, chosen])
        cloud = cloud[torch.randperm(cloud.shape[0], generator=gen,
                                     device=dev)]
        n = cloud.shape[0]
        pts[f, :n] = cloud
        valid[f, :n] = True
        if ground_points:
            g = torch.stack([
                _uniform(gen, (ground_points,), -crop_half_m, crop_half_m,
                         dev),
                _uniform(gen, (ground_points,), -crop_half_m, crop_half_m,
                         dev),
                GROUND_Z_M + 0.02 * torch.randn(ground_points, generator=gen,
                                                device=dev),
                torch.rand(ground_points, generator=gen, device=dev)], -1)
            pts[f, n:n + ground_points] = g
            ground[f, n:n + ground_points] = True
    return Drive(points=pts, valid=valid, ground=ground, counts=counts,
                 ego_x=ego_x, obj_centers=centers, obj_dims=dims,
                 obj_yaw=yaw, obj_speed=speed, obj_points=obj_n,
                 obj_local=local)


def stream_seed(seed: int, stream: int) -> int:
    """The seed of stream `stream` of a run seeded `seed`."""
    return (int(seed) * 1_000_003 + 7919 * (stream + 1)) % (2**62)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
