"""The port's bindings to the native host I/O runtime (io/native.py, built
by _build.build_native from native/src) against the port's pure decoders
(io/png.py, io/obj.py, the TUM reader's own decode) and against the JAX
package's build of the same runtime (its io/native outputs): the cases of
tests/test_native.py.

Tolerance: exact (pixels, frames, faces, uvs, vertices, boxes); smooth
normals within 1e-6 of the Python parser's (its sums run in another
order), exact against the reference's native parser."""

import numpy as np
import pytest
import torch
from PIL import Image

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import DEVICE

from octree_slam_tpu.io import native as jnative
from octree_slam_tpu_torch.io import native, obj, png, tum

pytestmark = pytest.mark.skipif(
    not native.available(),
    reason=f"the native runtime does not build here: {native.BUILD_ERROR}")


def test_reference_runtime_builds_where_the_port_does():
    """Both packages compile native/src with the same g++ and libpng, so
    the reference's build loads wherever the port's does, and the
    comparisons with the reference below are made wherever these tests
    run."""
    assert jnative.available()


@pytest.fixture
def tmp_png_pair(tmp_path):
    rng = np.random.default_rng(7)
    depth = rng.integers(0, 60000, (32, 40), dtype=np.uint16)
    rgb = rng.integers(0, 255, (32, 40, 3), dtype=np.uint8)
    dp, rp = str(tmp_path / "d.png"), str(tmp_path / "c.png")
    Image.fromarray(depth).save(dp)
    Image.fromarray(rgb).save(rp)
    return depth, rgb, dp, rp


def test_unloadable_cached_library_is_rebuilt(tmp_path, monkeypatch):
    """A cached library that does not load (one built on another host and
    copied with the checkout) is compiled again on first use, so that a
    failure would be this host's own compiler or loader error."""
    from octree_slam_tpu_torch import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    stale = _build.native_lib_path()
    stale.write_bytes(b"not a shared object")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.load_library() is not None, native.BUILD_ERROR
    assert stale.read_bytes()[:4] == b"\x7fELF"


def test_png_16bit_roundtrip(tmp_png_pair):
    depth, _, dp, _ = tmp_png_pair
    got = native.read_png(dp)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, depth)
    np.testing.assert_array_equal(got, png.read_png(dp))
    np.testing.assert_array_equal(got, jnative.read_png(dp))


def test_png_rgb_roundtrip(tmp_png_pair):
    _, rgb, _, rp = tmp_png_pair
    got = native.read_png(rp)
    np.testing.assert_array_equal(got, rgb)
    np.testing.assert_array_equal(got, png.read_png(rp))


def test_png_rgba_alpha_stripped(tmp_path):
    rgba = np.dstack([np.full((8, 8), 9, np.uint8)] * 3 +
                     [np.full((8, 8), 200, np.uint8)])
    p = str(tmp_path / "a.png")
    Image.fromarray(rgba).save(p)
    got = native.read_png(p)
    assert got.shape == (8, 8, 3)
    np.testing.assert_array_equal(got, rgba[..., :3])
    np.testing.assert_array_equal(got, png.read_png(p)[..., :3])


def test_png_write_then_read(tmp_path):
    rgb = np.arange(8 * 6 * 3, dtype=np.uint8).reshape(8, 6, 3)
    p = str(tmp_path / "w.png")
    native.write_png(p, rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), rgb)
    np.testing.assert_array_equal(png.read_png(p), rgb)
    # save_image goes through it, and the file reads back the same way
    from octree_slam_tpu_torch.io.bmp import save_image
    q = str(tmp_path / "fb.png")
    save_image(q, rgb.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(png.read_png(q), rgb)


def test_png_missing_file_raises():
    with pytest.raises(IOError):
        native.read_png("/nonexistent/really.png")


def test_prefetcher_in_order_and_scaled(tmp_path):
    n = 7
    dps, rps = [], []
    for i in range(n):
        d = np.full((16, 20), 5000 * (i + 1), np.uint16)
        c = np.full((16, 20, 3), i * 11, np.uint8)
        dp, rp = str(tmp_path / f"d{i}.png"), str(tmp_path / f"c{i}.png")
        Image.fromarray(d).save(dp)
        Image.fromarray(c).save(rp)
        dps.append(dp)
        rps.append(rp)
    with native.FramePrefetcher(dps, rps, 20, 16, depth_to_mm=0.2,
                                n_threads=3, capacity=3) as pf:
        assert len(pf) == n
        for i in range(n):
            depth_mm, rgb = pf.next()
            assert depth_mm[0, 0] == 1000 * (i + 1)
            assert rgb[5, 5, 1] == i * 11
        assert pf.next() is None


def test_prefetcher_shape_mismatch_errors(tmp_path):
    dp, rp = str(tmp_path / "d.png"), str(tmp_path / "c.png")
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(dp)
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(rp)
    with native.FramePrefetcher([dp], [rp], 99, 99) as pf:
        with pytest.raises(IOError):
            pf.next()


OBJ = """# test mesh
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
vt 0 0
vt 1 0
vt 1 1
vn 0 0 1
vn 0 1 0
f 1/1/1 2/2/1 3/3/1
f 1//2 3//2 4//2
f -5 -4 -1
f 1 2 3 4
"""


@pytest.mark.parametrize("text", [OBJ, "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 2\n"
                                       "f 1 2 3\nf 1 2 4\n"])
def test_obj_native_matches_python(tmp_path, text):
    """The native parser against the port's Python one (io/obj.py), with
    normals in the file and without (smooth normals)."""
    p = str(tmp_path / "m.obj")
    with open(p, "w") as f:
        f.write(text)
    v, n, fc, uv, lo, hi = native.load_obj_arrays(p)
    m = obj._load_obj_py(p, device=DEVICE)
    np.testing.assert_array_equal(v, m.vertices.numpy())
    np.testing.assert_allclose(n, m.normals.numpy(), atol=1e-6)
    np.testing.assert_array_equal(fc, m.faces.numpy())
    np.testing.assert_array_equal(uv, m.texcoords.numpy())
    np.testing.assert_array_equal(lo, m.bbox.bbox0.numpy())
    np.testing.assert_array_equal(hi, m.bbox.bbox1.numpy())
    if "vn" not in text:
        assert np.allclose(np.linalg.norm(n, axis=1)[:3], 1.0, atol=1e-5)
    for a, b in zip((v, n, fc, uv, lo, hi), jnative.load_obj_arrays(p)):
        np.testing.assert_array_equal(a, b)


def test_tum_prefetched_matches_frame(tmp_path):
    """TUMDataset.prefetched() (the native prefetcher feeding the upload
    thread) yields the frames of frame(i) and of the pure decoder."""
    root = tmp_path
    (root / "rgb").mkdir()
    (root / "depth").mkdir()
    rng = np.random.default_rng(3)
    rgb_lines, depth_lines = [], []
    for i in range(4):
        t = 100.0 + i * 0.033
        d = rng.integers(0, 30000, (24, 32), dtype=np.uint16)
        c = rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
        Image.fromarray(d).save(root / "depth" / f"{i}.png")
        Image.fromarray(c).save(root / "rgb" / f"{i}.png")
        depth_lines.append(f"{t} depth/{i}.png")
        rgb_lines.append(f"{t + 0.005} rgb/{i}.png")
    (root / "depth.txt").write_text("\n".join(depth_lines))
    (root / "rgb.txt").write_text("\n".join(rgb_lines))

    ds = tum.TUMDataset(str(root), device=DEVICE)
    assert len(ds) == 4
    for ahead in (0, 2):
        got = list(ds.prefetched(ahead=ahead))
        assert len(got) == 4
        for i, fr in enumerate(got):
            ref = ds.frame(i)
            assert torch.equal(fr.depth, ref.depth)
            assert torch.equal(fr.color, ref.color)
            raw = png.read_png(str(root / "depth" / f"{i}.png"))
            np.testing.assert_array_equal(
                fr.depth.numpy(),
                np.clip(raw.astype(np.float32) / tum.DEPTH_FACTOR_TO_MM, 0,
                        65535).astype(np.uint16))
