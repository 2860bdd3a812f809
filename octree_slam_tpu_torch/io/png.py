"""PNG reading and writing on zlib and numpy alone (the port's counterpart
of the reference package's native libpng codec and its PIL fallback,
octree_slam_tpu/io/native.py and io/tum.py:124-134, and of the PIL reader
behind its Scene.load_texture).

The reader takes every PNG the standard defines: greyscale at 1, 2, 4, 8
and 16 bits, RGB and RGBA at 8 and 16, grey+alpha at 8 and 16, palette
images at 1, 2, 4 and 8 bits, with any of the five row filters, plain or
Adam7-interlaced. `to_rgb8` turns what it returns into 8-bit RGB as PIL's
convert("RGB") does. The writer stores 16-bit grey, 8-bit grey, RGB and
RGBA with filter 0 on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, and the bit depths the standard allows it
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_BITS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
         6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


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


def _stride(width: int, ch: int, bits: int) -> int:
    return (width * ch * bits + 7) // 8


def _samples(raw: np.ndarray, height: int, width: int, ch: int,
             bits: int) -> np.ndarray:
    """One (sub-)image's filtered rows -> its samples [height, width, ch]
    as stored: u16 at 16 bits, else u8 (1, 2 and 4-bit samples unpacked,
    not scaled)."""
    stride = _stride(width, ch, bits)
    rows = _unfilter(raw, height, stride, max(1, ch * bits // 8))
    if bits == 16:
        return rows.view(">u2").astype(np.uint16).reshape(height, width, ch)
    if bits < 8:
        rows = np.unpackbits(rows, axis=1).reshape(height, -1, bits)
        weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
        rows = (rows * weights).sum(-1, dtype=np.uint8)[:, :width * ch]
    return rows.reshape(height, width, ch)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file: u16[H, W] for 16-bit greyscale, u8[H, W] for
    greyscale at 8 bits and below (1, 2 and 4-bit samples scaled to
    0..255), u8 / u16 [H, W, 2 | 3 | 4] for grey+alpha, RGB and RGBA at 8 /
    16 bits, and u8[H, W, 3] for a palette image, its indices looked up in
    PLTE (a tRNS chunk's transparency is not read)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, bits, ctype, _, _, interlace = header
    if bits not in _BITS.get(ctype, ()):
        raise ValueError(f"{path}: {bits}-bit colour type {ctype} is not a "
                         f"PNG kind")
    if interlace not in (0, 1):
        raise ValueError(f"{path}: unknown interlace method {interlace}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    # (x0, y0, dx, dy) of every (sub-)image in stream order
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [((height - y0 + dy - 1) // dy, (width - x0 + dx - 1) // dx)
             for x0, y0, dx, dy in passes]
    need = sum(h * (_stride(w, ch, bits) + 1)
               for h, w in sizes if h and w)
    if raw.size != need:
        raise ValueError(f"{path}: image data holds {raw.size} bytes, the "
                         f"header needs {need}")
    img = np.empty((height, width, ch), np.uint16 if bits == 16 else np.uint8)
    pos = 0
    for (x0, y0, dx, dy), (h, w) in zip(passes, sizes):
        if not (h and w):
            continue
        n = h * (_stride(w, ch, bits) + 1)
        img[y0::dy, x0::dx] = _samples(raw[pos:pos + n], h, w, ch, bits)
        pos += n
    if ctype == 3:
        # indices past the palette's end read black
        lut = np.zeros((256, 3), np.uint8)
        lut[:palette.shape[0]] = palette[:256]
        return lut[img[..., 0]]
    if bits < 8:
        img = img * np.uint8(255 // ((1 << bits) - 1))
    return img[..., 0] if ch == 1 else img


def to_rgb8(img: np.ndarray) -> np.ndarray:
    """read_png's image as u8[H, W, 3], as PIL's convert("RGB") makes it
    (PIL 12.1): alpha dropped, grey repeated, 16-bit grey clipped to 255,
    16-bit colour and grey+alpha reduced to their high byte."""
    if img.dtype == np.uint16:
        img = (np.minimum(img, 255) if img.ndim == 2 else img >> 8).astype(
            np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    elif img.shape[-1] == 2:
        img = img[..., :1]
    return np.ascontiguousarray(np.broadcast_to(
        img[..., :3], img.shape[:2] + (3,)))


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
