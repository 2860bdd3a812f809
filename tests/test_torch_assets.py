"""Port parity for the asset readers against the reference's public entry
points: io/obj.load_obj against octree_slam_tpu.io.obj.load_obj (its
native route included), Scene.load_texture against
octree_slam_tpu.scene.Scene.load_texture on every PNG kind (the port's
codec, io/png.py) and on JPEG and TGA (PIL in both), and
TUMDataset.prefetched's signature, knobs and per-array upload.

PNG files of every kind are written by an encoder of their own
(tests/png_encoder.py: any bit depth and colour type, PLTE and tRNS
chunks, Adam7, a random row filter a row) from seeded numpy samples.

Tolerance: exact (mesh arrays, float32 texels, frames)."""

import inspect
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import png_encoder
from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import DEVICE

from octree_slam_tpu.io import obj as jobj
from octree_slam_tpu.io import tum as jtum
from octree_slam_tpu.scene import Scene as JScene
from octree_slam_tpu_torch.io import native, obj, tum
from octree_slam_tpu_torch.scene import Scene

# ---------------------------------------------------------------- OBJ ---

OBJ_VN = """v 0 0 0
v 1 0 0.25
v 1 1 0
v 0 1 0.5
vt 0 0
vt 1 1
vn 0 0 1
vn 0 0.6 0.8
f 1/1/1 2/2/2 3/1/1 4/2/2
"""


def _random_obj(rng, colours: bool) -> str:
    """A seeded soup of 60 triangles over 40 vertices without normals
    (the parsers sum smooth normals), optionally with vertex colours."""
    v = rng.uniform(-1, 1, (40, 3))
    c = rng.uniform(0, 1, (40, 3))
    rows = [("v %.6f %.6f %.6f" % tuple(p))
            + (" %.4f %.4f %.4f" % tuple(q) if colours else "")
            for p, q in zip(v, c)]
    rows += ["f %d %d %d" % tuple(f)
             for f in rng.integers(1, 41, (60, 3))]
    return "\n".join(rows) + "\n"


@pytest.mark.parametrize("kind", ["vn", "smooth", "colours"])
def test_load_obj_matches_reference(tmp_path, monkeypatch, kind):
    """Equal bit for bit to the reference's public load_obj, and by the
    same route: the native parser when the runtime is built and the file
    has no vertex colours, else the Python one."""
    rng = np.random.default_rng(5)
    text = OBJ_VN if kind == "vn" else _random_obj(rng, kind == "colours")
    path = str(tmp_path / "m.obj")
    with open(path, "w") as f:
        f.write(text)
    calls = []
    native_load = native.load_obj_arrays
    monkeypatch.setattr(native, "load_obj_arrays",
                        lambda p: calls.append(p) or native_load(p))
    t = obj.load_obj(path, device=DEVICE)
    j = jobj.load_obj(path)
    assert len(calls) == int(native.available() and kind != "colours")
    for name in ("vertices", "normals", "colors", "faces", "texcoords"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(t.bbox.bbox0.numpy(),
                                  np.asarray(j.bbox.bbox0))
    np.testing.assert_array_equal(t.bbox.bbox1.numpy(),
                                  np.asarray(j.bbox.bbox1))

# ----------------------------------------------------------- textures ---


def _texture_files(tmp_path, case):
    """The files of one case: [(name, path, PIL's rule or None)], the rule
    being the u8 RGB that the reference's PIL makes of the samples."""
    rng = np.random.default_rng(sum(map(ord, case)))
    out = []

    def add(name, samples, bits, ctype, rule=None, **kw):
        path = str(tmp_path / f"{name}.png")
        png_encoder.write_png(path, samples, bits, ctype, seed=len(out),
                              **kw)
        out.append((name, path, rule))

    hw = (11, 13)
    if case == "palette":
        for bits in (1, 2, 4, 8):
            pal = rng.integers(0, 256, (1 << bits, 3))
            idx = rng.integers(0, 1 << bits, hw)
            add(f"p{bits}", idx, bits, 3, pal[idx], palette=pal)
    elif case == "palette_trns":
        pal = rng.integers(0, 256, (16, 3))
        idx = rng.integers(0, 16, hw)
        add("p8t", idx, 8, 3, pal[idx], palette=pal,
            trns=bytes(range(0, 160, 10)))
    elif case == "grey_alpha":
        la8 = rng.integers(0, 256, hw + (2,))
        la16 = rng.integers(0, 65536, hw + (2,))
        add("la8", la8, 8, 4, np.repeat(la8[..., :1], 3, -1))
        add("la16", la16, 16, 4, np.repeat(la16[..., :1] >> 8, 3, -1))
    elif case == "grey_low_bits":
        for bits in (1, 2, 4):
            g = rng.integers(0, 1 << bits, hw)
            scaled = g * (255 // ((1 << bits) - 1))
            add(f"g{bits}", g, bits, 0, np.repeat(scaled[..., None], 3, -1))
    elif case == "grey16":
        # PIL 12.1 clips 16-bit grey to 255 (it does not take the high
        # byte): [0, 200, 300, 65535] -> [0, 200, 255, 255]
        g = np.concatenate([[[0, 200, 300, 65535]],
                            rng.integers(0, 65536, (3, 4))])
        add("g16", g, 16, 0, np.repeat(np.minimum(g, 255)[..., None], 3, -1))
    elif case == "colour16":
        # PIL 12.1 reduces 16-bit RGB(A) to its high byte
        rgb = rng.integers(0, 65536, hw + (3,))
        rgba = rng.integers(0, 65536, hw + (4,))
        add("rgb16", rgb, 16, 2, rgb >> 8)
        add("rgba16", rgba, 16, 6, rgba[..., :3] >> 8)
    elif case == "interlaced":
        rgb = rng.integers(0, 256, (19, 23, 3))
        g2 = rng.integers(0, 4, (9, 3))
        pal = rng.integers(0, 256, (16, 3))
        idx = rng.integers(0, 16, (7, 10))
        rgba = rng.integers(0, 65536, (5, 6, 4))
        add("i_rgb8", rgb, 8, 2, rgb, interlace=True)
        add("i_g2", g2, 2, 0, np.repeat(g2[..., None] * 85, 3, -1),
            interlace=True)
        add("i_p4", idx, 4, 3, pal[idx], palette=pal, interlace=True)
        add("i_rgba16", rgba, 16, 6, rgba[..., :3] >> 8, interlace=True)
    else:  # formats only PIL reads, in both packages
        rgb = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
        for ext in ("jpg", "tga"):
            path = str(tmp_path / f"t.{ext}")
            Image.fromarray(rgb).save(path)
            out.append((ext, path, None))
    return out


@pytest.mark.parametrize("case", [
    "palette", "palette_trns", "grey_alpha", "grey_low_bits", "grey16",
    "colour16", "interlaced", "pil_formats"])
def test_texture_matches_reference(tmp_path, case):
    """Scene.load_texture equals the reference's (PIL's convert("RGB") /
    255) as float32 texels; the PNG rules of PIL 12.1 are pinned beside."""
    for name, path, rule in _texture_files(tmp_path, case):
        t = Scene(device=DEVICE).load_texture(path).data.numpy()
        j = np.asarray(JScene().load_texture(path).data)
        assert t.dtype == j.dtype == np.float32, name
        np.testing.assert_array_equal(t, j, err_msg=name)
        if rule is not None:
            np.testing.assert_array_equal(
                np.asarray(Image.open(path).convert("RGB")),
                np.asarray(rule, np.uint8), err_msg=name)


def test_texture_without_pil(tmp_path, monkeypatch):
    """Where PIL is missing a PNG of every kind still
    reads; another format raises the ValueError that names it."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    scene = Scene(device=DEVICE)
    idx = np.arange(12, dtype=np.uint8).reshape(3, 4)
    pal = np.arange(36, dtype=np.uint8).reshape(12, 3) * 7
    path = str(tmp_path / "p.png")
    png_encoder.write_png(path, idx, 8, 3, palette=pal)
    np.testing.assert_array_equal(scene.load_texture(path).data.numpy(),
                                  pal[idx].astype(np.float32) / 255.0)
    with pytest.raises(ValueError, match="'tga'.*PIL"):
        scene.load_texture(str(tmp_path / "t.tga"))

# ------------------------------------------------------------- ingest ---


def _sequence(root, n=4):
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    rng = np.random.default_rng(3)
    rgb_lines, depth_lines = [], []
    for i in range(n):
        t = 100.0 + i * 0.033
        d = rng.integers(0, 30000, (24, 32), dtype=np.uint16)
        c = rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
        Image.fromarray(d).save(root / "depth" / f"{i}.png")
        Image.fromarray(c).save(root / "rgb" / f"{i}.png")
        depth_lines.append(f"{t} depth/{i}.png")
        rgb_lines.append(f"{t + 0.005} rgb/{i}.png")
    (root / "depth.txt").write_text("\n".join(depth_lines))
    (root / "rgb.txt").write_text("\n".join(rgb_lines))
    return tum.TUMDataset(str(root), device=DEVICE)


def test_prefetched_signature_and_knobs(tmp_path, monkeypatch):
    """The reference's parameters in its order with its defaults, and
    n_threads / capacity reach the native prefetcher."""
    def params(f):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(f).parameters.values()]
    assert params(tum.TUMDataset.prefetched) == \
        params(jtum.TUMDataset.prefetched)
    seen = []

    class Spy(native.FramePrefetcher):
        def __init__(self, *args, **kw):
            seen.append((kw["n_threads"], kw["capacity"]))
            super().__init__(*args, **kw)

    monkeypatch.setattr(native, "FramePrefetcher", Spy)
    ds = _sequence(tmp_path)
    assert native.available()
    assert len(list(ds.prefetched(2, 5))) == 4
    assert len(list(ds.prefetched(ahead=0))) == 4
    assert seen == [(2, 5), (3, 8)]


def test_prefetched_per_array_frames(tmp_path):
    """packed=False (depth and rgb uploaded apart) yields the packed
    path's frames and frame(i)'s, in the caller's thread and fed ahead."""
    ds = _sequence(tmp_path)
    for ahead in (0, 2):
        split = list(ds.prefetched(packed=False, ahead=ahead))
        whole = list(ds.prefetched(packed=True, ahead=ahead))
        assert len(split) == len(whole) == 4
        for i, (a, b) in enumerate(zip(split, whole)):
            ref = ds.frame(i)
            for f in (a, b):
                assert f.depth.dtype == ref.depth.dtype == torch.int32
                assert torch.equal(f.depth, ref.depth)
                assert torch.equal(f.color, ref.color)
                assert float(f.timestamp) == float(ref.timestamp)
