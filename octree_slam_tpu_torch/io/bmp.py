"""BMP textures and image output (counterpart: octree_slam_tpu/io/bmp.py).

`load_bmp` is Scene::loadBMP (scene.cpp:36-62) with the pixel-data offset
parsed and rows 4-byte aligned (the reference reads a fixed 54-byte header
and no row padding). `save_bmp` writes the 24-bit files it reads, for
textures made in code; `save_image` writes framebuffers as PNG through the
native runtime's libpng (io/native.py) where it builds, else through the
port's own codec (the machine the port runs on has no PIL).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from octree_slam_tpu_torch.core.types import Texture
from octree_slam_tpu_torch.io.png import write_png


def load_bmp(path: str, device="cuda") -> Texture:
    """A 24- or 32-bit uncompressed BMP (bottom-up or top-down rows;
    BI_BITFIELDS only with BGRA masks) as float RGB in [0, 1], top row
    first. The alpha byte of 32-bit texels is dropped."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    pixel_offset = struct.unpack_from("<I", data, 10)[0]
    width = struct.unpack_from("<i", data, 18)[0]
    height = struct.unpack_from("<i", data, 22)[0]
    bpp = struct.unpack_from("<H", data, 28)[0]
    if bpp not in (24, 32):
        raise ValueError(f"{path}: only 24/32-bit BMP supported (got {bpp})")
    compression = struct.unpack_from("<I", data, 30)[0]
    if compression == 3:  # BI_BITFIELDS: masks may reorder the channels
        masks = struct.unpack_from("<III", data, 54)
        if masks != (0x00FF0000, 0x0000FF00, 0x000000FF):
            raise ValueError(
                f"{path}: BI_BITFIELDS with non-BGRA channel masks "
                f"{tuple(hex(m) for m in masks)} is not supported")
    elif compression != 0:  # BI_RGB
        raise ValueError(f"{path}: compressed BMP (type {compression}) "
                         "is not supported")
    ch = bpp // 8
    flip = height > 0  # a positive height stores the rows bottom-up
    height = abs(height)
    row_bytes = (width * ch + 3) & ~3
    img = np.frombuffer(data, np.uint8, count=row_bytes * height,
                        offset=pixel_offset)
    img = img.reshape(height, row_bytes)[:, : width * ch] \
        .reshape(height, width, ch)
    if flip:
        img = img[::-1]
    # BGR(A) -> RGB (voxelization.cu:135 writes its own alpha)
    rgb = img[..., 2::-1].astype(np.float32) / 255.0
    return Texture(data=torch.from_numpy(np.ascontiguousarray(rgb))
                   .to(device))


def save_bmp(path: str, rgb) -> None:
    """Write u8[H, W, 3] RGB as a 24-bit bottom-up BMP (BI_RGB)."""
    arr = np.asarray(rgb, np.uint8)
    h, w, _ = arr.shape
    row_bytes = (w * 3 + 3) & ~3
    rows = np.zeros((h, row_bytes), np.uint8)
    rows[:, : w * 3] = arr[::-1, :, ::-1].reshape(h, w * 3)
    header = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size,
                       2835, 2835, 0, 0)
    with open(path, "wb") as f:
        f.write(header + info + rows.tobytes())


def save_image(path: str, rgba) -> None:
    """Write a framebuffer ([H, W, 3|4] float in [0, 1], or uint8) as a
    PNG, the replacement of the GL window's presentation: through the
    native runtime's libpng where it builds, else the port's codec."""
    arr = np.asarray(rgba)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    if not path.endswith(".png"):
        raise ValueError(f"save_image writes PNG only, got {path!r}")
    from octree_slam_tpu_torch.io import native
    if native.available():
        native.write_png(path, arr)
        return
    write_png(path, arr)
