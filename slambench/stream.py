"""The benchmark's RGB-D stream: a frozen copy of the port's synthetic
desk scene, its closed-form frame renderer and its orbit camera
(octree_slam_tpu_torch/sensor/sources.py: default_scene, render_frame,
orbit_pose), kept here so that a change to the program cannot move the
yardstick, plus the Kinect axial depth noise the traffic file asks for.

`make_stream` makes the stream a traffic file names by its `kind`; the
orbit renders every frame of one loop on the device in set-up. The seed sets the orbit's starting frame and the noise draws;
every seed gets the same loop of poses, in another order.

Conventions are the sensor path's: the camera looks down +z; pixel (x, y)
backprojects to ((x - W/2) d/fx, (H/2 - y) d/fy, d); depth is millimetres
held as int32, 0 = no return.
"""

from __future__ import annotations

import math
from importlib import util as importlib_util
from pathlib import Path
from typing import NamedTuple

import torch
import torch.nn.functional as F

_BIG = 1.0e9
BENCH_DIR = Path(__file__).resolve().parent


class Scene(NamedTuple):
    spheres: torch.Tensor        # f32[ns, 4] (cx, cy, cz, r)
    sphere_albedo: torch.Tensor  # f32[ns, 3]
    boxes: torch.Tensor          # f32[nb, 6] (lo, hi)
    box_albedo: torch.Tensor     # f32[nb, 3]
    planes: torch.Tensor         # f32[np, 4] (normal, offset: n.p = off)
    plane_albedo: torch.Tensor   # f32[np, 3]


class Stream(NamedTuple):
    """One loop of frames on the device, in the order the run serves them.
    Frame i of a run is row i % len."""

    depth: torch.Tensor   # i32[n, H, W] millimetres, 0 = no return
    color: torch.Tensor   # u8[n, H, W, 3]
    poses: torch.Tensor   # f32[n, 4, 4] ground-truth world_T_cam

    def __len__(self):
        return self.depth.shape[0]


def desk_scene(device) -> Scene:
    """Floor, back wall, three coloured spheres and a box."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)
    return Scene(
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


SCENES = {"desk": desk_scene}


def _intersect(scene: Scene, origin: torch.Tensor, dirs: torch.Tensor):
    """Closed-form ray casting; t is in units of |dirs| (z = 1 camera rays
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


def render_frame(scene: Scene, world_T_cam: torch.Tensor, fx, fy, *,
                 width: int, height: int, noise=None, gen=None,
                 max_range=None, light_dir=(0.4, 0.8, 0.45)):
    """One RGB-D frame (z-depth rays, Lambertian shading) on the scene's
    device: (depth i32[H, W] mm, colour u8[H, W, 3]). With `noise` =
    (a, b, z0) every return gets Gaussian axial noise of
    sigma(z) = a + b (z - z0)^2 metres drawn from `gen`, rounded to the
    millimetre and kept at 1 mm or more. Surfaces beyond `max_range`
    metres (z-depth) give no return, depth 0 and black."""
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
    if max_range is not None:
        hit = hit & (t <= max_range)
    if noise is not None:
        a, b, z0 = noise
        sigma = a + b * (t - z0) ** 2
        draw = torch.randn(t.shape, generator=gen, device=dev,
                           dtype=torch.float32)
        t = torch.where(hit, torch.clamp(t + sigma * draw, min=1e-3), t)
    depth_mm = torch.where(hit, torch.round(t * 1000.0), 0.0)
    depth_mm = torch.clamp(depth_mm, 0, 65535).to(torch.int32)

    lvec = torch.tensor(light_dir, dtype=torch.float32, device=dev)
    lvec = lvec / torch.linalg.vector_norm(lvec)
    lam = 0.25 + 0.75 * torch.clamp(torch.sum(nrm * lvec, dim=-1), 0.0, 1.0)
    rgb = torch.clamp(alb * lam[..., None], 0.0, 1.0)
    color = torch.where(hit[..., None], torch.round(rgb * 255.0), 0.0).to(
        torch.uint8)
    return depth_mm, color


def orbit_pose(angle, radius: float, height: float, device,
               target=(0.0, 0.0, 0.0)) -> torch.Tensor:
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
    T = torch.eye(4, dtype=torch.float32, device=device)
    T[:3, :3] = torch.stack([xaxis, yaxis, z], dim=1)
    T[:3, 3] = eye
    return T


def start_frame(seed: int, frames_per_loop: int) -> int:
    """The loop frame a run starts at."""
    return seed % frames_per_loop


def make_stream(traffic: dict, slam: dict, seed: int, device,
                bench_dir: Path = BENCH_DIR) -> Stream:
    """The stream of a traffic mix, by its `kind` (default "orbit"): the
    orbit below, or bench_dir/streams/<kind>.py's
    make(traffic, slam, seed, device), which a later mix may add."""
    kind = traffic.get("kind", "orbit")
    if kind == "orbit":
        return orbit_stream(traffic, slam, seed, device)
    path = bench_dir / "streams" / f"{kind}.py"
    spec = importlib_util.spec_from_file_location(
        f"slambench.streams.{kind}", path)
    mod = importlib_util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make(traffic, slam, seed, device)


def orbit_stream(traffic: dict, slam: dict, seed: int, device) -> Stream:
    """Every frame of one orbit loop, rendered on `device` from `seed`.

    traffic: the mix's parameters (slambench/traffic/<name>.json);
    slam: the configuration's SLAMConfig fields (image size, focals)."""
    n = int(traffic["frames_per_loop"])
    step = 2.0 * math.pi / n
    s0 = start_frame(seed, n)
    scene = SCENES[traffic["scene"]](device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    nz = traffic.get("depth_noise")
    noise = None if nz is None else (nz["a_m"], nz["b_per_m2"], nz["z0_m"])
    w, h = slam["width"], slam["height"]
    depth = torch.empty((n, h, w), dtype=torch.int32, device=device)
    color = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    poses = torch.empty((n, 4, 4), dtype=torch.float32, device=device)
    for i in range(n):
        k = (s0 + i) % n
        pose = orbit_pose(k * step, traffic["radius_m"], traffic["height_m"],
                          device)
        depth[i], color[i] = render_frame(
            scene, pose, slam["focal_x"], slam["focal_y"], width=w, height=h,
            noise=noise, gen=gen, max_range=traffic.get("max_range_m"))
        poses[i] = pose
    return Stream(depth=depth, color=color, poses=poses)
