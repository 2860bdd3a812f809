"""RGBA8 voxel value packing (counterpart: octree_slam_tpu/core/packing.py).

Node colour is one 32-bit word r | g<<8 | b<<16 | a<<24 (svo.cu:332). The
port holds these words as int32 bit patterns: a word whose alpha is above
127 is negative as an int32, so every unpack masks with `& 0xFF` after the
(arithmetic) shift. `unpack_rgba_unit` is left for the slice that needs it.
"""

from __future__ import annotations

import torch

# Fresh node: rgb=0, alpha=127 (svo.cu:274); positive as an int32.
EMPTY_VALUE = 127 << 24
OCCUPIED_ALPHA = 127                 # occupied iff alpha > 127 (svo.cu:528)


def pack_rgba8(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               a: torch.Tensor) -> torch.Tensor:
    """Pack integer channels (0..255) into an int32 word."""
    r = torch.clamp(r, 0, 255).to(torch.int32)
    g = torch.clamp(g, 0, 255).to(torch.int32)
    b = torch.clamp(b, 0, 255).to(torch.int32)
    a = torch.clamp(a, 0, 255).to(torch.int32)
    return r | (g << 8) | (b << 16) | (a << 24)


def unpack_rgba8(value: torch.Tensor):
    """Unpack an int32 word into integer channels (0..255) as int32."""
    return (value & 0xFF, (value >> 8) & 0xFF, (value >> 16) & 0xFF,
            (value >> 24) & 0xFF)


def alpha_of(value: torch.Tensor) -> torch.Tensor:
    return (value >> 24) & 0xFF


def is_occupied(value: torch.Tensor) -> torch.Tensor:
    """Occupancy test: alpha > 127 (svo.cu:528)."""
    return alpha_of(value) > OCCUPIED_ALPHA


def blend_value(old_value: torch.Tensor, new_rgb: torch.Tensor) -> torch.Tensor:
    """Pseudo low-pass fusion of a new colour sample into a node value
    (svo.cu:326-332): with a = old alpha,
      out_rgb = new_rgb*255 * (1 - a/256) + old_rgb * (a/256)
      out_a   = min(255, a + 2)
    `new_rgb` is float in [0,1], shape [..., 3]; `old_value` int32[...].

    Every op rounds on its own, as written. XLA's compiled reference
    reassociates `new_rgb*255*f1` and contracts the sum into one FMA, so
    a channel can land one level apart from it at an integer boundary."""
    r, g, b, a = unpack_rgba8(old_value)
    old_rgb = torch.stack([r, g, b], dim=-1).to(torch.float32)
    af = a.to(torch.float32)[..., None]
    f2 = af / 256.0
    f1 = 1.0 - f2
    out = new_rgb * 255.0 * f1 + old_rgb * f2
    out = out.to(torch.int32)
    new_a = torch.clamp(a + 2, max=255)
    return pack_rgba8(out[..., 0], out[..., 1], out[..., 2], new_a)
