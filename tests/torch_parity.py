"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; data
crosses as numpy arrays (u32 words as int32 bit patterns, u16 depth as
int32). torch is pinned to one thread: the test workers share the cores.
"""

from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(1)

INVALID_KEY = 0x7FFFFFFF


def to_t(x) -> torch.Tensor:
    """numpy (or a JAX array) -> CPU tensor with the port's dtypes."""
    a = np.array(x, order="C", copy=True)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint16:
        a = a.astype(np.int32)
    return torch.from_numpy(a)


def words(x) -> np.ndarray:
    """Packed words of either package as uint32 numpy."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.int32).view(np.uint32) if a.dtype != np.uint32 else a


def rand_depth(h, w, seed, batch=None):
    """Random u16 depth in [400, 6000) mm with 10% zero holes."""
    rng = np.random.default_rng(seed)
    shape = (h, w) if batch is None else (batch, h, w)
    d = rng.uniform(400, 6000, shape).astype(np.uint16)
    d[rng.random(shape) < 0.1] = 0
    return d


def random_cloud(n, seed, lo=-0.9, hi=0.9):
    """Random points in [lo, hi)^3 with colours in [0, 1)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return pts, cols


def _fma32(a, b, c):
    """float32 fused multiply-add (exact product in float64, one final
    rounding to float32)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def xla_blend(old_words: np.ndarray, seg_sum: np.ndarray,
              seg_cnt: np.ndarray) -> np.ndarray:
    """The leaf blend as XLA:CPU compiles the reference's insert: the
    segment mean's `/ 255.0` becomes a multiply by the float32 reciprocal,
    `new*255*f1` reassociates to `new*(f1*255)`, and the sum contracts into
    one FMA. Returns uint32 words; explains every leaf where the port
    (each op rounded as written) lands one level apart."""
    f32 = np.float32
    old = old_words.astype(np.uint32)
    rgb = np.stack([(old >> s) & 0xFF for s in (0, 8, 16)], -1).astype(f32)
    a = ((old >> 24) & 0xFF).astype(np.int32)
    mean = (seg_sum.astype(f32) / np.maximum(seg_cnt.astype(f32), f32(1))
            [:, None]).astype(f32) * (f32(1) / f32(255))
    f2 = (a.astype(f32) / f32(256))[:, None]
    f1 = f32(1) - f2
    out = _fma32(mean, (f1 * f32(255)).astype(f32), (rgb * f2).astype(f32))
    out = np.clip(out.astype(np.int32), 0, 255).astype(np.uint32)
    na = np.minimum(a + 2, 255).astype(np.uint32)
    return out[:, 0] | (out[:, 1] << 8) | (out[:, 2] << 16) | (na << 24)


def orbit_frames(cfg, n, step_angle=0.015, radius=2.0):
    """The reference package's synthetic orbit stream as numpy:
    (depth u16 [n,H,W], color u8 [n,H,W,3], gt poses f32 [n,4,4])."""
    import jax.numpy as jnp
    from octree_slam_tpu.sensor import sources
    scene = sources.default_scene()
    depths, colors, poses = [], [], []
    for i in range(n):
        gt = sources.orbit_pose(i * step_angle, radius=radius)
        f = sources.render_frame(scene, jnp.asarray(gt), cfg.focal_x,
                                 cfg.focal_y, width=cfg.width,
                                 height=cfg.height)
        depths.append(np.asarray(f.depth))
        colors.append(np.asarray(f.color))
        poses.append(np.asarray(gt))
    return np.stack(depths), np.stack(colors), np.stack(poses)
