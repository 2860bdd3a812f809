"""Pinhole camera model and view / projection matrix builders (counterpart:
octree_slam_tpu/core/camera.py).

The glm::lookAt / perspective of the GLFW fly camera
(glfw_camera_controller.cpp:82-88) and the pinhole constants of the sensor
path (image_kernels.cu:49-51).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from octree_slam_tpu_torch.core.types import Camera


class Intrinsics(NamedTuple):
    """Focal lengths and principal point in pixels, float32 values held as
    Python floats (the port's renderers take them so)."""

    fx: float
    fy: float
    cx: float
    cy: float


def intrinsics_from_fov(width: int, height: int, h_fov_deg: float,
                        v_fov_deg: float) -> Intrinsics:
    """Focal length from field of view, as OpenNIDevice computes it
    (openni_device.cpp:64-65: f = size / (2 tan(fov / 2)))."""
    fx = width / (2.0 * math.tan(math.radians(h_fov_deg) / 2.0))
    fy = height / (2.0 * math.tan(math.radians(v_fov_deg) / 2.0))
    f32 = np.float32
    return Intrinsics(fx=float(f32(fx)), fy=float(f32(fy)),
                      cx=float(f32(width / 2.0)), cy=float(f32(height / 2.0)))


def look_at(eye: torch.Tensor, center: torch.Tensor,
            up: torch.Tensor) -> torch.Tensor:
    """Right-handed view matrix (glm::lookAt)."""
    f = center - eye
    f = f / torch.linalg.vector_norm(f)
    s = torch.linalg.cross(f, up)
    s = s / torch.linalg.vector_norm(s)
    u = torch.linalg.cross(s, f)
    m = torch.eye(4, dtype=torch.float32, device=eye.device)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -torch.dot(s, eye)
    m[1, 3] = -torch.dot(u, eye)
    m[2, 3] = torch.dot(f, eye)
    return m


def perspective(fov_y_deg, aspect: float, z_near: float = 0.001,
                z_far: float = 10000.0, device="cuda") -> torch.Tensor:
    """Right-handed perspective projection (glm::perspective; the near and
    far defaults of glfw_camera_controller.cpp:20-21)."""
    fov_y = torch.deg2rad(torch.as_tensor(fov_y_deg, dtype=torch.float32,
                                          device=device))
    t = 1.0 / torch.tan(fov_y / 2.0)
    m = torch.zeros((4, 4), dtype=torch.float32, device=device)
    m[0, 0] = t / aspect
    m[1, 1] = t
    m[2, 2] = -(z_far + z_near) / (z_far - z_near)
    m[2, 3] = -(2.0 * z_far * z_near) / (z_far - z_near)
    m[3, 2] = -1.0
    return m


def make_camera(eye, center, up, fov_y_deg: float, aspect: float,
                z_near: float = 0.001, z_far: float = 10000.0,
                device="cuda") -> Camera:
    def vec(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    eye, center, up = vec(eye), vec(center), vec(up)
    return Camera(
        model=torch.eye(4, dtype=torch.float32, device=device),
        view=look_at(eye, center, up),
        projection=perspective(fov_y_deg, aspect, z_near, z_far,
                               device=device),
        fov=torch.tensor(fov_y_deg, dtype=torch.float32, device=device))
