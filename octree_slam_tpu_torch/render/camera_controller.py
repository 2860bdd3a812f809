"""Virtual fly camera (counterpart:
octree_slam_tpu/render/camera_controller.py).

GLFWCameraController (glfw_camera_controller.cpp:16-106) as a pure update
of host floats: WASD / arrow translation, drag look, scroll field of view;
the inputs come from whatever drives the framebuffer. The reference's
deltaTime bug (:45 assigns instead of subtracting) is not reproduced.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np

from octree_slam_tpu_torch.core import camera as cam_mod
from octree_slam_tpu_torch.core.types import Camera


@dataclass(frozen=True)
class FlyCameraState:
    position: Tuple[float, float, float] = (0.0, 0.0, 3.0)
    yaw: float = math.pi          # radians; pi looks down -z
    pitch: float = 0.0
    fov: float = 45.0             # degrees, scroll-adjustable
    move_speed: float = 2.0       # m/s
    look_speed: float = 0.2       # rad per normalized drag unit


@dataclass(frozen=True)
class CameraInputs:
    forward: float = 0.0   # +1 W / -1 S
    strafe: float = 0.0    # +1 D / -1 A
    rise: float = 0.0      # +1 up / -1 down
    drag_x: float = 0.0    # normalized mouse drag
    drag_y: float = 0.0
    scroll: float = 0.0    # FoV delta


def _forward(yaw: float, pitch: float) -> np.ndarray:
    return np.array([math.sin(yaw) * math.cos(pitch), math.sin(pitch),
                     math.cos(yaw) * math.cos(pitch)])


def update(state: FlyCameraState, inputs: CameraInputs,
           dt: float) -> FlyCameraState:
    """Advance the camera by one tick (the reference's update(),
    glfw_camera_controller.cpp:38-80)."""
    yaw = state.yaw + inputs.drag_x * state.look_speed
    pitch = float(np.clip(state.pitch + inputs.drag_y * state.look_speed,
                          -1.5, 1.5))
    fwd = _forward(yaw, pitch)
    # right = normalize(cross(forward, up)), look_at's s = f x up (the
    # closed form at zero pitch)
    right = np.array([-math.cos(yaw), 0.0, math.sin(yaw)])
    up = np.array([0.0, 1.0, 0.0])
    pos = np.asarray(state.position) + state.move_speed * dt * (
        inputs.forward * fwd + inputs.strafe * right + inputs.rise * up)
    fov = float(np.clip(state.fov + inputs.scroll, 10.0, 120.0))
    return replace(state, position=tuple(pos), yaw=yaw, pitch=pitch, fov=fov)


def camera(state: FlyCameraState, aspect: float, z_near: float = 0.001,
           z_far: float = 10000.0, device="cuda") -> Camera:
    """View and projection matrices on `device`
    (glfw_camera_controller.cpp:82-88)."""
    pos = np.asarray(state.position)
    return cam_mod.make_camera(pos, pos + _forward(state.yaw, state.pitch),
                               (0.0, 1.0, 0.0), state.fov, aspect, z_near,
                               z_far, device=device)
