"""SE(3) utilities (counterpart: octree_slam_tpu/core/se3.py).

Transforms are 4x4 matrices acting on column vectors, T = [[R, t], [0, 1]];
a twist is x = [omega(3), v(3)]. The vertex and normal maps are
transformed by sensor/image_ops (transform_vertex_map / _normal_map).
"""

from __future__ import annotations

import torch


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w: hat(w) @ v == cross(w, v)."""
    zero = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zero, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def _rodrigues_coeffs(w: torch.Tensor):
    """theta^2, sin(t)/t, (1-cos(t))/t^2 with series fallbacks near 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-30)
    small = theta < 1e-5
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    return theta2, small, a, b


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation from an axis-angle vector (safe at theta -> 0)."""
    _, _, a, b = _rodrigues_coeffs(w)
    K = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def exp_se3(twist: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential of [omega, v] -> 4x4 transform."""
    w, v = twist[..., :3], twist[..., 3:]
    theta2, small, a, b = _rodrigues_coeffs(w)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    K = hat(w)
    KK = K @ K
    eye = torch.eye(3, dtype=twist.dtype, device=twist.device)
    R = eye + a[..., None, None] * K + b[..., None, None] * KK
    V = eye + b[..., None, None] * K + c[..., None, None] * KK
    t = (V @ v[..., None])[..., 0]
    # assembled from device tensors only: writing a Python scalar into a
    # CUDA tensor is a host-to-device copy that synchronises
    T = torch.eye(4, dtype=twist.dtype, device=twist.device).repeat(
        twist.shape[:-1] + (1, 1))
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def inverse(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    out = torch.eye(4, dtype=T.dtype, device=T.device).repeat(
        T.shape[:-2] + (1, 1))
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ t[..., None])[..., 0]
    return out


def transform_points(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply T to points, w = 1 (transformVertexMap,
    image_kernels.cu:206-219)."""
    return p @ T[..., :3, :3].transpose(-1, -2) + T[..., :3, 3]


def transform_dirs(T: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Apply T to directions, w = 0 (transformNormalMap,
    image_kernels.cu:221-234)."""
    return d @ T[..., :3, :3].transpose(-1, -2)
