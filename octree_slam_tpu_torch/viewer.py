"""Scripted fly-camera map viewer (counterpart: octree_slam_tpu/viewer.py).

The reference couples a GLFW window to a fly camera and re-renders the map
every tick (main.cpp:47,115-124, glfw_camera_controller.cpp:38-106). With
no display, a movement script expands to one CameraInputs a tick,
render/camera_controller integrates them as the GLFW handler would, and
every tick's map render is written as a PNG frame.

Script (semicolon-separated, times in seconds at --fps ticks):
    w 1.0            fly forward 1 s        (arrows / WASD, :52-67)
    s | a | d        back / strafe left / right
    up 0.5 | down    vertical
    look 0.4 -0.1    drag by (dx, dy) normalized units (:69-80)
    zoom -10         field of view change in degrees (:94-99)
    wait 0.5         hold position (renders frames)

    python -m octree_slam_tpu_torch.viewer --load-state map.npz \\
        --out flight/ --script "look 0.3 0; w 1.5; look 0 -0.2; s 0.5"

Without --load-state it builds a small synthetic-orbit map first.
"""

from __future__ import annotations

import argparse
import math
import pathlib
from typing import Iterator, List, Tuple

import numpy as np
import torch

from octree_slam_tpu_torch.render import camera_controller as fly
from octree_slam_tpu_torch.render import conesplat
from octree_slam_tpu_torch.render.splat import render_splat


def parse_script(script: str, fps: float) -> List[fly.CameraInputs]:
    """Expand the movement script into one CameraInputs per tick."""
    ticks: List[fly.CameraInputs] = []
    moves = {"w": dict(forward=1.0), "s": dict(forward=-1.0),
             "d": dict(strafe=1.0), "a": dict(strafe=-1.0),
             "up": dict(rise=1.0), "down": dict(rise=-1.0), "wait": {}}
    for cmd in script.split(";"):
        parts = cmd.strip().split()
        if not parts:
            continue
        op = parts[0].lower()
        args = [float(x) for x in parts[1:]]
        dur = args[0] if op in moves and args else 0.5
        n = max(1, round(dur * fps))
        if op in moves:
            ticks += [fly.CameraInputs(**moves[op])] * n
        elif op == "look":
            dx, dy = args[0], args[1] if len(args) > 1 else 0.0
            n = max(1, round(0.5 * fps))
            ticks += [fly.CameraInputs(drag_x=dx / n, drag_y=dy / n)] * n
        elif op == "zoom":
            ticks.append(fly.CameraInputs(scroll=args[0]))
        else:
            raise ValueError(f"unknown viewer command {op!r}")
    return ticks


def sensor_pose(state: fly.FlyCameraState, aspect: float) -> np.ndarray:
    """world_T_cam f32[4, 4] in the sensor convention (+z forward, x right)
    of a fly-camera state, which follows the GL look-at convention (the
    view looks down -z): the x and z basis columns flipped."""
    cam = fly.camera(state, aspect=aspect, device="cpu")
    pose = np.linalg.inv(cam.view.numpy()).astype(np.float32)
    pose[:3, 0] *= -1.0
    pose[:3, 2] *= -1.0
    return pose


def fly_poses(start: fly.FlyCameraState, ticks: List[fly.CameraInputs],
              dt: float) -> Iterator[Tuple[fly.FlyCameraState, np.ndarray]]:
    """Integrate the script into sensor-convention world_T_cam poses."""
    state = start
    for inp in ticks:
        state = fly.update(state, inp, dt)
        yield state, sensor_pose(state, 4.0 / 3.0)


def start_state(pool) -> fly.FlyCameraState:
    """In front of the map's centre, looking down -z at it."""
    c = pool.center.cpu().numpy()
    return fly.FlyCameraState(
        position=(float(c[0]), float(c[1]),
                  float(c[2]) + 0.6 * float(pool.half_size)),
        yaw=math.pi)


def slab_spec(cfg, pool, width: int, height: int, fx: float):
    return conesplat.make_slab_spec(
        width=width, height=height, fx=fx,
        leaf_size=2.0 * float(pool.half_size) / (1 << cfg.max_depth),
        z_near=cfg.cone_znear, z_far=cfg.max_range,
        n_slabs=cfg.cone_slabs, max_scale=cfg.cone_max_scale)


def render_view(pool, leaves, cfg, pose: np.ndarray, f: float, mode: str,
                spec, width: int, height: int) -> torch.Tensor:
    """One map view f32[H, W, 4] on the pool's device: the slab cone or
    the splat renderer."""
    T = torch.from_numpy(pose).to(pool.center.device)
    if mode == "cone":
        return conesplat.render_cone_splat(
            leaves, pool.center, pool.half_size, T, f, f, spec=spec,
            depth=cfg.max_depth)
    return render_splat(pool, leaves, T, f, f, width=width, height=height,
                        depth=cfg.max_depth, max_range=cfg.max_range)


def run_viewer(pool, leaves, cfg, *, script: str, out_dir: str,
               start: fly.FlyCameraState | None = None,
               mode: str = "cone", fps: float = 10.0) -> int:
    """Render the scripted flight over a map as PNG frames; returns the
    frame count."""
    from octree_slam_tpu_torch.io.bmp import save_image

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if start is None:
        start = start_state(pool)
    spec = slab_spec(cfg, pool, cfg.width, cfg.height, cfg.focal_x)
    n = 0
    for state, pose in fly_poses(start, parse_script(script, fps),
                                 1.0 / fps):
        # the scroll's field of view sets the focal length, as the
        # reference rebuilds perspective(fov) each tick (:85)
        f = cfg.height / 2.0 / math.tan(math.radians(state.fov) / 2.0)
        fb = render_view(pool, leaves, cfg, pose, f, mode, spec, cfg.width,
                         cfg.height)
        save_image(str(out / f"fly_{n:05d}.png"), fb.cpu().numpy())
        n += 1
    return n


DEFAULT_SCRIPT = "wait 0.3; look 0.25 0; w 0.4; look -0.5 0; w 0.4; " \
                 "look 0.25 -0.1; up 0.25; zoom -8; wait 0.3"


def orbit_map(cfg, frames: int, device):
    """The state after `frames` frames of the synthetic orbit, and the
    config that matches its shapes after any growth."""
    from octree_slam_tpu_torch import app
    from octree_slam_tpu_torch.sensor import sources
    scene = sources.default_scene(device)
    gt = [sources.orbit_pose(i * 0.01, radius=2.0, device=device)
          for i in range(frames)]
    sink: list = []
    res = app.run_slam(
        lambda i: sources.render_frame(scene, gt[i], cfg.focal_x,
                                       cfg.focal_y, width=cfg.width,
                                       height=cfg.height),
        frames, cfg, initial_pose=gt[0], render_every=0, state_out=sink,
        device=device)
    return sink[0], res.final_cfg


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="scripted fly-camera viewer")
    p.add_argument("--load-state", type=str, default=None,
                   help="SLAM state .npz from the app's --save-state")
    p.add_argument("--out", type=str, default="out_fly")
    p.add_argument("--script", type=str, default=DEFAULT_SCRIPT)
    p.add_argument("--mode", choices=["cone", "splat"], default="cone")
    p.add_argument("--fps", type=float, default=10.0)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--max-depth", type=int, default=9)
    p.add_argument("--resolution", type=float, default=0.02)
    p.add_argument("--node-capacity", type=int, default=1 << 20)
    p.add_argument("--orbit-frames", type=int, default=8,
                   help="without --load-state: frames of synthetic orbit "
                        "SLAM that build the map to fly through")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cpu for a run without a card)")
    args = p.parse_args(argv)
    from octree_slam_tpu_torch import app
    from octree_slam_tpu_torch.config import SLAMConfig

    dev = app.resolve_device(args.device)
    cfg = SLAMConfig(width=args.width, height=args.height,
                     max_depth=args.max_depth,
                     voxel_resolution=args.resolution,
                     node_capacity=args.node_capacity,
                     leaf_capacity=args.node_capacity >> 3)
    if args.load_state:
        state, cfg = app.load_state(args.load_state, cfg, device=dev)
    else:
        state, cfg = orbit_map(cfg, args.orbit_frames, dev)
    n = run_viewer(state.pool, state.leaves, cfg, script=args.script,
                   out_dir=args.out, mode=args.mode, fps=args.fps)
    print(f"wrote {n} flight frames to {args.out}/")
    return n


if __name__ == "__main__":
    main()
