"""Reference depth pyramid and ICP: the port's plain stencils
(sensor/cuda_ops.py bilateral_plain, gated_subsample_plain, to which its
CUDA kernels are bit-exact), its vertex and normal maps
(sensor/image_ops.py) and its Gauss-Newton tracker (sensor/tracking.py,
core/se3.py), written out op for op so that float32 gives the program's
bits, with every matrix product through `Arith.mm`.

Only the configurations' path is here: no photometric term, no keyframe
anchor, no row slabs; `check_config` refuses anything else.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from . import Arith

INVALID_DEPTH_MAX_MM = 15000

Level = Tuple[torch.Tensor, torch.Tensor]   # (vertex, normal) f32[h, w, 3]


def check_config(slam: dict) -> None:
    """Raise for a SLAMConfig setting this reference does not follow."""
    unsupported = {"w_rgbd": 0.0, "track_keyframe": False,
                   "track_finest_level": 0, "fuse_level": 0,
                   "icp_symmetric": True, "saturation_gate": False,
                   "insert_dircache": False}
    for key, want in unsupported.items():
        if slam.get(key, want) != want:
            raise ValueError(f"the reference follows {key}={want!r} only, "
                             f"got {slam[key]!r}")


def bilateral(depth: torch.Tensor, sigma_spatial: float, sigma_depth: float,
              kernel_size: int) -> torch.Tensor:
    """Bilateral filter of int32 depth [H, W]: taps dy outer, dx inner,
    outside the image weighing 0, round half even."""
    half = kernel_size // 2
    h, w = depth.shape[-2:]
    sig_s = 0.5 / (sigma_spatial * sigma_spatial)
    sig_d = 0.5 / (sigma_depth * sigma_depth)
    d = depth.to(torch.float32)
    pad = F.pad(d, (half, half, half, half))
    inb = F.pad(torch.ones_like(d), (half, half, half, half))
    s1 = torch.zeros_like(d)
    s2 = torch.zeros_like(d)
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            nb = pad[..., half + dy:half + dy + h, half + dx:half + dx + w]
            m = inb[..., half + dy:half + dy + h, half + dx:half + dx + w]
            space2 = float(dx * dx + dy * dy)
            diff = d - nb
            wgt = m * torch.exp(-(space2 * sig_s + diff * diff * sig_d))
            s1 = s1 + nb * wgt
            s2 = s2 + wgt
    return torch.round(s1 / s2).to(depth.dtype)


def gated_subsample(depth: torch.Tensor, gate: float) -> torch.Tensor:
    """Mean of the in-image 5x5 neighbours of (2y, 2x) within `gate` mm of
    it (0 when none pass), truncated: [H // 2, W // 2]."""
    h, w = depth.shape[-2:]
    oh, ow = h // 2, w // 2
    d = depth.to(torch.float32)
    pad = F.pad(d, (2, 2, 2, 2))
    inb = F.pad(torch.ones_like(d), (2, 2, 2, 2))
    c = d[..., 0:2 * oh:2, 0:2 * ow:2]
    s = torch.zeros_like(c)
    cnt = torch.zeros_like(c)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            rows = slice(2 + dy, 2 + dy + 2 * oh, 2)
            cols = slice(2 + dx, 2 + dx + 2 * ow, 2)
            nb = pad[..., rows, cols]
            ok = inb[..., rows, cols] * (torch.abs(nb - c) < gate).to(
                torch.float32)
            s = s + nb * ok
            cnt = cnt + ok
    out = torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), 0.0)
    return out.to(depth.dtype)


def vertex_map(depth_mm: torch.Tensor, fx, fy, img_w: int,
               img_h: int) -> torch.Tensor:
    """Pinhole backprojection of a pyramid level of the img_w x img_h
    sensor image: f32[h, w, 3], INF where depth is 0 or beyond 15 m."""
    h, w = depth_mm.shape[-2:]
    dev = depth_mm.device
    d = depth_mm.to(torch.float32)
    x = torch.arange(w, dtype=torch.float32, device=dev).expand(h, w)
    y = torch.arange(0, h, dtype=torch.float32, device=dev)[:, None].expand(
        h, w)
    milli = 1e-3
    vx = ((img_w / w) * x - img_w / 2.0) * d / fx * milli
    vy = (img_h / 2.0 - (img_h / h) * y) * d / fy * milli
    vz = d * milli
    v = torch.stack([vx, vy, vz], dim=-1)
    invalid = (depth_mm == 0) | (depth_mm > INVALID_DEPTH_MAX_MM)
    return torch.where(invalid[..., None], torch.inf, v)


def normal_map(vertex: torch.Tensor) -> torch.Tensor:
    """normalize(-cross(v[x+1] - v, v[y+1] - v)); right and bottom edges
    invalid."""
    h, w, _ = vertex.shape[-3:]
    v1 = torch.roll(vertex, -1, dims=-2) - vertex
    v2 = torch.roll(vertex, -1, dims=-3) - vertex
    n = -torch.linalg.cross(v1, v2, dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    edge = torch.zeros((h, w), dtype=torch.bool, device=vertex.device)
    edge[:, w - 1] = True
    edge[h - 1, :] = True
    bad = edge | ~torch.isfinite(n).all(dim=-1)
    return torch.where(bad[..., None], torch.inf, n)


def pyramid(depth: torch.Tensor, slam: dict, levels: int | None = None
            ) -> List[Level]:
    """(vertex, normal) of each pyramid level, finest first; `levels`
    limits how many are made (the fusion needs level 0 alone)."""
    n_lvl = slam["pyramid_depth"] if levels is None else levels
    filtered = bilateral(depth, slam["bilateral_sigma_spatial"],
                         slam["bilateral_sigma_depth"],
                         slam["bilateral_kernel_size"])
    depths = [filtered]
    for _ in range(n_lvl - 1):
        depths.append(gated_subsample(depths[-1],
                                      3.0 * slam["bilateral_sigma_depth"]))
    out = []
    for d in depths:
        v = vertex_map(d, slam["focal_x"], slam["focal_y"], slam["width"],
                       slam["height"])
        out.append((v, normal_map(v)))
    return out


# --- SE(3) -----------------------------------------------------------------

def _hat(w: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([zero, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], zero, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], zero], dim=-1)], dim=-2)


def exp_se3(twist: torch.Tensor, ar: Arith) -> torch.Tensor:
    """SE(3) exponential of [omega, v] -> 4x4 transform."""
    w, v = twist[..., :3], twist[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-30)
    small = theta < 1e-5
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    K = _hat(w)
    KK = ar.mm(K, K)
    eye = torch.eye(3, dtype=twist.dtype, device=twist.device)
    R = eye + a[..., None, None] * K + b[..., None, None] * KK
    V = eye + b[..., None, None] * K + c[..., None, None] * KK
    t = ar.mm(V, v[..., None])[..., 0]
    T = torch.eye(4, dtype=twist.dtype, device=twist.device).repeat(
        twist.shape[:-1] + (1, 1))
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


# --- ICP -------------------------------------------------------------------

def _icp_sums(v1, n1, v2, n2, slam: dict, ar: Arith):
    v1 = v1.reshape(-1, 3)
    n1 = n1.reshape(-1, 3)
    v2 = v2.reshape(-1, 3)
    n2 = n2.reshape(-1, 3)
    finite = (torch.isfinite(v1).all(-1) & torch.isfinite(v2).all(-1)
              & torch.isfinite(n1).all(-1) & torch.isfinite(n2).all(-1))
    fm = finite[:, None]
    v1c = torch.where(fm, v1, 0.0)
    v2c = torch.where(fm, v2, 0.0)
    n1c = torch.where(fm, n1, 0.0)
    n2c = torch.where(fm, n2, 0.0)
    z_min, z_max = slam["icp_z_min"], slam["icp_z_max"]
    z_ok = ((v1c[:, 2] > z_min) & (v2c[:, 2] > z_min)
            & (v1c[:, 2] < z_max) & (v2c[:, 2] < z_max))
    diff = v2c - v1c
    dist_ok = torch.sum(diff * diff, dim=-1) <= slam["icp_dist_thresh"] ** 2
    norm_ok = torch.sum(n2c * n1c, dim=-1) >= slam["icp_norm_thresh"]
    mask = finite & z_ok & dist_ok & norm_ok
    ns = n1c + n2c
    J = torch.cat([torch.linalg.cross(v2c, ns, dim=-1), ns], dim=-1)
    r = torch.sum(ns * (v1c - v2c), dim=-1)
    w = mask.to(torch.float32)
    k = slam["icp_huber_k"]
    if k > 0.0:
        w = w * torch.clamp(k / torch.clamp(torch.abs(r), min=1e-9), max=1.0)
    A = ar.mm((J * w[:, None]).T, J)
    b = ar.mm(r * w, J)
    return A, b, mask.sum(dtype=torch.int32)


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(6, dtype=A.dtype, device=A.device)
    damped = A + 1e-6 * torch.trace(A) * eye + 1e-12 * eye
    L, info = torch.linalg.cholesky_ex(damped)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info > 0, torch.nan, x)


def track(last: List[Level], cur: List[Level], slam: dict, ar: Arith):
    """Coarse-to-fine ICP of the current frame's pyramid against the last
    one's, from the identity: (cam_{t-1}_T_cam_t f32[4, 4], diverged)."""
    T, diverged, _ = track_inliers(last, cur, slam, ar)
    return T, diverged


def track_inliers(last: List[Level], cur: List[Level], slam: dict,
                  ar: Arith):
    """`track`, and the finest level's inlier count i32[] at its last
    iteration (the program's TrackStats.inliers[-1])."""
    dev = cur[0][0].device
    T = torch.eye(4, dtype=torch.float32, device=dev)
    diverged = torch.zeros((), dtype=torch.bool, device=dev)
    zero = torch.zeros(6, dtype=torch.float32, device=dev)
    iters = slam["pyramid_iters"]
    count = None
    for level in range(slam["pyramid_depth"] - 1, -1, -1):
        v1, n1 = last[level]
        cv, cn = cur[level]
        for _ in range(iters[level]):
            v2t = ar.mm(cv, T[:3, :3].T) + T[:3, 3]
            n2t = ar.mm(cn, T[:3, :3].T)
            A, b, count = _icp_sums(v1, n1, v2t, n2t, slam, ar)
            x = _solve(A, b)
            bad = ~torch.isfinite(x).all() | (count < 6)
            T = ar.mm(exp_se3(torch.where(bad, zero, x), ar), T)
            diverged = diverged | bad
    return T, diverged, count
