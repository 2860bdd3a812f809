"""Image output (counterpart: octree_slam_tpu/io/bmp.py). `save_image` is
ported on the port's PNG writer; `load_bmp` waits for the offline paths
that read textures.
"""

from __future__ import annotations

import numpy as np

from octree_slam_tpu_torch.io.png import write_png


def save_image(path: str, rgba) -> None:
    """Write a framebuffer ([H, W, 3|4] float in [0, 1], or uint8) as a
    PNG, the replacement of the GL window's presentation."""
    arr = np.asarray(rgba)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    if not path.endswith(".png"):
        raise ValueError(f"save_image writes PNG only, got {path!r}")
    write_png(path, arr)
