"""A PNG encoder of its own, independent of the port's codec (io/png.py)
and of PIL, so that a reader is never held against files made by the
module it checks: any bit depth and colour type, PLTE and tRNS chunks,
Adam7 interlacing, a random one of the five row filters a row (drawn
from `seed`). numpy and zlib only, so it runs where neither JAX nor PIL
is installed."""

from __future__ import annotations

import struct
import zlib

import numpy as np

# colour type -> channels
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def pack_rows(s: np.ndarray, bits: int) -> np.ndarray:
    """Samples [h, w, ch] -> the bytes of h rows at `bits` a sample."""
    h = s.shape[0]
    if bits == 16:
        return s.astype(">u2").view(np.uint8).reshape(h, -1)
    flat = s.reshape(h, -1).astype(np.uint8)
    if bits == 8:
        return flat
    per = 8 // bits
    flat = np.concatenate(
        [flat, np.zeros((h, (-flat.shape[1]) % per), np.uint8)], 1)
    flat = flat.reshape(h, -1, per)
    out = np.zeros(flat.shape[:2], np.uint8)
    for j in range(per):
        out |= flat[..., j] << (8 - bits * (j + 1))
    return out


def filter_rows(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Each row with a random one of the five filters."""
    out = []
    prior = np.zeros(rows.shape[1], np.int32)
    for cur in rows.astype(np.int32):
        kind = int(rng.integers(0, 5))
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) >> 1
        else:
            p = left + prior - ul
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, ul))
        out.append(bytes([kind])
                   + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prior = cur
    return b"".join(out)


def write_png(path: str, samples, bits: int, ctype: int, palette=None,
              trns: bytes | None = None, interlace: bool = False,
              seed: int = 0) -> None:
    """Store `samples` ([h, w] or [h, w, ch], as the colour type has
    channels; palette indices for type 3) at `bits` a sample."""
    s = np.asarray(samples)
    s = s[..., None] if s.ndim == 2 else s
    h, w, ch = s.shape
    assert ch == CHANNELS[ctype]
    rng = np.random.default_rng(seed)
    bpp = max(1, ch * bits // 8)
    subs = ([s[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7] if interlace
            else [s])
    raw = b"".join(filter_rows(pack_rows(sub, bits), bpp, rng)
                   for sub in subs if sub.size)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, bits, ctype, 0, 0, int(interlace)))
    if palette is not None:
        data += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        data += chunk(b"tRNS", trns)
    data += chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)
