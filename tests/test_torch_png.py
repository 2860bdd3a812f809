"""Port parity for the PNG codec: io/png.py against PIL, every row filter
of the reader on 16-bit greyscale and 8-bit RGB, and the writer on
16-bit greyscale, 8-bit RGB and RGBA, both ways.

Tolerance: exact (pixels)."""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)

from octree_slam_tpu_torch.io import png


def _filtered_png(path, img, kind):
    """Write `img` as a PNG whose every row uses filter `kind` (0-4): the
    encoder side of the filters, so that the reader meets each one."""
    if img.dtype == np.uint16:
        raw, ctype, bits = img.astype(">u2").view(np.uint8), 0, 16
    else:
        raw, ctype, bits = img, {3: 2, 4: 6}[img.shape[-1]], 8
    h = img.shape[0]
    rows = raw.reshape(h, -1).astype(np.int32)
    bpp = 2 if bits == 16 else img.shape[-1]
    out = []
    prior = np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        line = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(line)
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
        out.append(np.concatenate([[kind], (line - pred) & 0xFF]))
        prior = line
    data = np.concatenate(out).astype(np.uint8).tobytes()

    def chunk(t, b):
        return (struct.pack(">I", len(b)) + t + b
                + struct.pack(">I", zlib.crc32(t + b) & 0xFFFFFFFF))

    w = img.shape[1]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, ctype,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(data)))
        f.write(chunk(b"IEND", b""))


def _image(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "grey16":
        return rng.integers(0, 65536, (9, 13)).astype(np.uint16)
    ch = 3 if kind == "rgb8" else 4
    return rng.integers(0, 256, (9, 13, ch)).astype(np.uint8)


@pytest.mark.parametrize("kind", ["grey16", "rgb8"])
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_png_reader_against_pil(tmp_path, kind, filt):
    img = _image(kind, filt)
    path = str(tmp_path / "x.png")
    _filtered_png(path, img, filt)
    ref = np.asarray(Image.open(path))
    np.testing.assert_array_equal(ref, img)
    got = png.read_png(path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("kind", ["grey16", "rgb8", "rgba8"])
def test_png_writer_against_pil(tmp_path, kind):
    img = _image(kind, 7)
    path = str(tmp_path / "y.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    # and PIL's own encoding (adaptive filters) reads back through ours
    Image.fromarray(img).save(tmp_path / "z.png")
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "z.png")), img)
