"""Frame sources: the synthetic RGB-D camera and replay streams
(counterpart: octree_slam_tpu/sensor/sources.py).

SyntheticScene renders exact depth + colour frames of analytic geometry
(spheres, axis-aligned boxes, planes) by closed-form ray casting, on any
device, so the port's benchmark stream is made where it runs. Conventions
match the sensor path: the camera looks down +z; pixel (x, y) backprojects
to ((x - W/2) d/fx, (H/2 - y) d/fy, d); depth is millimetres (held as
int32), 0 = no return.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from octree_slam_tpu_torch.core import se3
from octree_slam_tpu_torch.core.types import Frame

_BIG = 1.0e9


class SyntheticScene(NamedTuple):
    """Spheres [n,4] (cx,cy,cz,r), boxes [m,6] (lo,hi), planes [k,4]
    (normal, offset: n.p = off), each with an RGB albedo."""

    spheres: torch.Tensor        # f32[ns, 4]
    sphere_albedo: torch.Tensor  # f32[ns, 3]
    boxes: torch.Tensor          # f32[nb, 6]
    box_albedo: torch.Tensor     # f32[nb, 3]
    planes: torch.Tensor         # f32[np, 4]
    plane_albedo: torch.Tensor   # f32[np, 3]


def default_scene(device="cpu") -> SyntheticScene:
    """A small 'desk': floor + back wall + three coloured spheres + box."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)
    return SyntheticScene(
        spheres=f32([[0.0, 0.2, 0.0, 0.45],
                     [0.9, 0.0, 0.4, 0.3],
                     [-0.8, -0.1, -0.3, 0.25]]),
        sphere_albedo=f32([[0.9, 0.2, 0.15], [0.2, 0.8, 0.25],
                           [0.2, 0.3, 0.9]]),
        boxes=f32([[0.3, -0.5, -0.9, 0.9, 0.1, -0.4]]),
        box_albedo=f32([[0.9, 0.8, 0.2]]),
        planes=f32([[0.0, 1.0, 0.0, -0.5],    # floor y = -0.5
                    [0.0, 0.0, 1.0, -2.5]]),  # back wall z = -2.5
        plane_albedo=f32([[0.55, 0.5, 0.45], [0.6, 0.6, 0.65]]),
    )


def _intersect(scene: SyntheticScene, origin: torch.Tensor,
               dirs: torch.Tensor):
    """Closed-form ray casting; t is in units of |dirs| (z=1 camera rays
    make t the z-depth). Returns (t, albedo, normal)."""
    t_best = torch.full(dirs.shape[:-1], _BIG, dtype=torch.float32,
                        device=dirs.device)
    alb = torch.zeros(dirs.shape, dtype=torch.float32, device=dirs.device)
    nrm = torch.zeros(dirs.shape, dtype=torch.float32, device=dirs.device)

    def take(t_new, ok, a_new, n_new):
        nonlocal t_best, alb, nrm
        better = ok & (t_new < t_best) & (t_new > 1e-4)
        t_best = torch.where(better, t_new, t_best)
        alb = torch.where(better[..., None], a_new, alb)
        nrm = torch.where(better[..., None], n_new, nrm)

    for i in range(scene.spheres.shape[0]):
        c = scene.spheres[i, :3]
        r = scene.spheres[i, 3]
        oc = origin - c
        a = torch.sum(dirs * dirs, dim=-1)
        b = 2.0 * torch.sum(dirs * oc, dim=-1)
        cc = torch.dot(oc, oc) - r * r
        disc = b * b - 4 * a * cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = (-b - sq) / (2 * a)
        t1 = (-b + sq) / (2 * a)
        t = torch.where(t0 > 1e-4, t0, t1)
        hit = origin + t[..., None] * dirs
        take(t, disc > 0, scene.sphere_albedo[i], (hit - c) / r)

    for i in range(scene.boxes.shape[0]):      # slab method
        lo = scene.boxes[i, :3]
        hi = scene.boxes[i, 3:]
        inv = 1.0 / torch.where(torch.abs(dirs) < 1e-12, 1e-12, dirs)
        t0s = (lo - origin) * inv
        t1s = (hi - origin) * inv
        tmin = torch.amax(torch.minimum(t0s, t1s), dim=-1)
        tmax = torch.amin(torch.maximum(t0s, t1s), dim=-1)
        ok = (tmax >= tmin) & (tmax > 1e-4)
        t = torch.where(tmin > 1e-4, tmin, tmax)
        hit = origin + t[..., None] * dirs
        rel = (hit - 0.5 * (lo + hi)) / (0.5 * (hi - lo))
        axis = torch.argmax(torch.abs(rel), dim=-1)
        n = torch.sign(torch.gather(rel, -1, axis[..., None])) * F.one_hot(
            axis, 3).to(torch.float32)
        take(t, ok, scene.box_albedo[i], n)

    for i in range(scene.planes.shape[0]):
        n = scene.planes[i, :3]
        off = scene.planes[i, 3]
        denom = torch.sum(dirs * n, dim=-1)
        ok = torch.abs(denom) > 1e-9
        t = (off - torch.dot(origin, n)) / torch.where(ok, denom, 1.0)
        take(t, ok, scene.plane_albedo[i], n.expand(dirs.shape))

    return t_best, alb, nrm


def render_frame(scene: SyntheticScene, world_T_cam: torch.Tensor, fx, fy, *,
                 width: int, height: int,
                 light_dir=(0.4, 0.8, 0.45)) -> Frame:
    """Render an exact RGB-D frame (z-depth rays, Lambertian shading) on
    the scene's device."""
    dev = world_T_cam.device
    x = torch.arange(width, dtype=torch.float32, device=dev).expand(
        height, width)
    y = torch.arange(height, dtype=torch.float32, device=dev)[:, None].expand(
        height, width)
    d_cam = torch.stack([(x - width / 2.0) / fx, (height / 2.0 - y) / fy,
                         torch.ones_like(x)], dim=-1)
    R = world_T_cam[:3, :3]
    origin = world_T_cam[:3, 3]
    t, alb, nrm = _intersect(scene, origin, d_cam @ R.T)

    hit = t < _BIG
    depth_mm = torch.where(hit, torch.round(t * 1000.0), 0.0)
    depth_mm = torch.clamp(depth_mm, 0, 65535).to(torch.int32)

    lvec = torch.tensor(light_dir, dtype=torch.float32, device=dev)
    lvec = lvec / torch.linalg.vector_norm(lvec)
    lam = 0.25 + 0.75 * torch.clamp(torch.sum(nrm * lvec, dim=-1), 0.0, 1.0)
    rgb = torch.clamp(alb * lam[..., None], 0.0, 1.0)
    color = torch.where(hit[..., None], torch.round(rgb * 255.0), 0.0).to(
        torch.uint8)
    return Frame(depth=depth_mm, color=color,
                 timestamp=torch.zeros((), dtype=torch.float32, device=dev))


def orbit_pose(angle, radius: float = 2.0, height: float = 0.3,
               target=(0.0, 0.0, 0.0), device="cpu") -> torch.Tensor:
    """world_T_cam of a camera orbiting `target` and looking at it
    (x right, y up, z forward)."""
    angle = torch.as_tensor(angle, dtype=torch.float32).to(device)
    target = torch.as_tensor(target, dtype=torch.float32).to(device)
    eye = target + torch.stack([radius * torch.sin(angle),
                                torch.tensor(height, device=device),
                                radius * torch.cos(angle)])
    z = target - eye
    z = z / torch.linalg.vector_norm(z)
    up = torch.tensor([0.0, 1.0, 0.0], device=device)
    xaxis = torch.linalg.cross(up, z)
    xaxis = xaxis / torch.linalg.vector_norm(xaxis)
    yaxis = torch.linalg.cross(z, xaxis)
    return se3.make_transform(torch.stack([xaxis, yaxis, z], dim=1), eye)


class ReplaySource:
    """Host-side iterator over pre-recorded frames (numpy u16 depth and u8
    colour), moved to `device` one frame at a time."""

    def __init__(self, depths: np.ndarray, colors: np.ndarray,
                 timestamps: np.ndarray | None = None, device="cpu"):
        if depths.shape[0] != colors.shape[0]:
            raise ValueError("depths and colors differ in frame count")
        self.depths = depths
        self.colors = colors
        self.timestamps = (
            timestamps if timestamps is not None
            else np.arange(depths.shape[0], dtype=np.float32) / 30.0)
        self.device = device

    def __len__(self):
        return self.depths.shape[0]

    def frame(self, i: int) -> Frame:
        return Frame(
            depth=torch.from_numpy(self.depths[i].astype(np.int32)).to(
                self.device),
            color=torch.from_numpy(np.array(self.colors[i], np.uint8)).to(
                self.device),
            timestamp=torch.tensor(float(self.timestamps[i]),
                                   dtype=torch.float32, device=self.device),
        )
