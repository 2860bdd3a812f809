"""Packed z-buffer bit math (counterpart: octree_slam_tpu/render/points.py).

Only the pieces the splat renderer shares are ported: the no-hit sentinel
and the RGB565 packing. The point and voxel-cube renderers of the
reference wait for the offline slice.
"""

from __future__ import annotations

import torch

DEPTH_INF = 0x7FFFFFFF   # no-hit sentinel: above every packed depth word


def pack_rgb565(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """8-bit channels -> one 5-6-5 16-bit word."""
    return ((r >> 3) << 11) | ((g >> 2) << 5) | (b >> 3)


def unpack_rgb565(v: torch.Tensor):
    """5-6-5 word -> 8-bit channels, replicating the top bits into the low
    ones so full-scale values round-trip exactly (255 -> 255)."""
    r5 = (v >> 11) & 0x1F
    g6 = (v >> 5) & 0x3F
    b5 = v & 0x1F
    return (r5 << 3) | (r5 >> 2), (g6 << 2) | (g6 >> 4), (b5 << 3) | (b5 >> 2)
