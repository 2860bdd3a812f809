"""PNG reading and writing on zlib and numpy alone (the port's counterpart
of the reference package's native libpng codec and its PIL fallback,
octree_slam_tpu/io/native.py and io/tum.py:124-134).

The reader takes what RGB-D datasets store: 16-bit greyscale (TUM depth),
8-bit greyscale, 8-bit RGB and RGBA, non-interlaced, with any of the five
row filters. Palette images, other bit depths and Adam7 interlacing raise.
The writer stores the same kinds with filter 0 on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG ends before its IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    a, b, c = (x.astype(np.int16) for x in (a, b, c))
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a,
                    np.where(pb <= pc, b, c)).astype(np.uint8)


def _unfilter(raw: np.ndarray, height: int, stride: int,
              bpp: int) -> np.ndarray:
    """Undo the per-row filters of `raw` (height rows of 1 + stride bytes)
    into u8[height, stride]. Filters 0-2 are whole-row operations; 3 and 4
    depend on the pixel to the left, so they run pixel by pixel."""
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            # running sum modulo 256 along each byte lane of a pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prior
        elif kind in (3, 4):
            cur = line.copy()
            left = np.zeros(bpp, np.uint8)
            up_left = np.zeros(bpp, np.uint8)
            for x in range(0, stride, bpp):
                up = prior[x:x + bpp]
                if kind == 3:
                    pred = ((left.astype(np.uint16) + up) >> 1).astype(
                        np.uint8)
                else:
                    pred = _paeth(left, up, up_left)
                cur[x:x + bpp] = line[x:x + bpp] + pred
                left, up_left = cur[x:x + bpp], up
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prior = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file: u16[H, W] for 16-bit greyscale, u8[H, W] for
    8-bit greyscale, u8[H, W, 3 | 4] for RGB / RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, bits, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: colour type {ctype} is not supported "
                         f"(greyscale, RGB and RGBA are)")
    if bits not in (8, 16) or (bits == 16 and ctype != 0):
        raise ValueError(f"{path}: {bits}-bit colour type {ctype} is not "
                         f"supported")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    ch = _CHANNELS[ctype]
    bpp = ch * bits // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width * bpp + 1):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, the "
                         f"header needs {height * (width * bpp + 1)}")
    img = _unfilter(raw, height, width * bpp, bpp)
    if bits == 16:
        return img.view(">u2").astype(np.uint16).reshape(height, width)
    return img.reshape((height, width) if ch == 1 else (height, width, ch))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, compress_level: int = 6) -> None:
    """Encode u16[H, W], u8[H, W] or u8[H, W, 3 | 4] as a PNG file, every
    row with filter 0."""
    img = np.asarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        bits, ctype, rows = 16, 0, img.astype(">u2").view(np.uint8)
    elif img.dtype == np.uint8 and (img.ndim == 2 or img.shape[-1] in (3, 4)):
        bits = 8
        ctype = 0 if img.ndim == 2 else {3: 2, 4: 6}[img.shape[-1]]
        rows = img
    else:
        raise ValueError(f"write_png: cannot store {img.dtype} "
                         f"{tuple(img.shape)}")
    height, width = img.shape[:2]
    rows = rows.reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, bits,
                                            ctype, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(),
                                              compress_level)))
        f.write(_chunk(b"IEND", b""))
