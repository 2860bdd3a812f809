"""Port parity for the mesh I/O layer: core types (Mesh, Camera, the box
helpers), se3.transform_points / transform_dirs, core/camera.py, the OBJ
reader and writer against the JAX package's (its Python parser
_load_obj_py, and its public load_obj: the native parser where the
runtime builds and the file has no vertex colours, else the Python one),
the BMP reader and metrics.rpe.

Tolerances: parsed arrays, boxes, BMP texels and integer data equal;
matrices and transformed points within 1e-6 (their 3- and 4-term sums are
ordered as torch and XLA order them, an ulp apart at most); rpe within
1e-12 (both are numpy)."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import DEVICE

from octree_slam_tpu.core import camera as jcamera
from octree_slam_tpu.core import se3 as jse3
from octree_slam_tpu.core import types as jtypes
from octree_slam_tpu.io import bmp as jbmp
from octree_slam_tpu.io import obj as jobj
from octree_slam_tpu.utils import metrics as jmetrics
from octree_slam_tpu_torch.core import camera, se3, types
from octree_slam_tpu_torch.io import bmp, obj
from octree_slam_tpu_torch.utils import metrics

CUBE_OBJ = """
# a cube of quads with texcoords
v -1 -1 -1
v 1 -1 -1
v 1 1 -1
v -1 1 -1
v -1 -1 1
v 1 -1 1
v 1 1 1
v -1 1 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
f 1/1 2/2 3/3 4/4
f 5/1 8/4 7/3 6/2
f 1/1 5/2 6/3 2/4
f 2/1 6/2 7/3 3/4
f 3/1 7/2 8/3 4/4
f 4/1 8/2 5/3 1/4
"""
# vn with negative indices, a pentagon fan, a 1-field vt, v//vn and v/vt/vn
NEG_OBJ = """
v 0 0 0
v 1 0 0
v 0 1 0
vn 0 0 1
vn 0 1 0
vt 0.25
f -3//-2 -2//-2 -1//-1
v 2 0 0.5
v 2.5 1 0.5
v 1.5 1.8 0.5
v 0.5 1 0.5
f 4/1/1 5/1/2 6/1/1 7/1/2 -7/1/1
"""
COLOR_OBJ = """
v 0 0 0 1 0 0
v 1 0 0 0 1 0
v 0 1 0
v 0 0 1 0.5 0.5 0.5
f 1 2 3
f 1 3 4
f 2 4 3
"""


def _mesh_equal(t, j):
    for name in ("vertices", "normals", "colors", "faces", "texcoords"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(t.bbox.bbox0.numpy(),
                                  np.asarray(j.bbox.bbox0))
    np.testing.assert_array_equal(t.bbox.bbox1.numpy(),
                                  np.asarray(j.bbox.bbox1))


def test_box_helpers_and_camera_type():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    pts[3] = np.nan
    pts[7, 1] = np.inf
    valid = rng.random(50) < 0.8
    for v in (None, valid):
        tb = types.bbox_of_points(torch.from_numpy(pts),
                                  None if v is None else torch.from_numpy(v))
        jb = jtypes.bbox_of_points(jnp.asarray(pts),
                                   None if v is None else jnp.asarray(v))
        np.testing.assert_array_equal(tb.bbox0.numpy(), np.asarray(jb.bbox0))
        np.testing.assert_array_equal(tb.bbox1.numpy(), np.asarray(jb.bbox1))
    outer = ([-1, -1, -1], [1, 1, 1])
    for inner in (([-0.5, 0, 0], [0.5, 0.9, 1]), ([-0.5, 0, 0], [1.5, 0.2, 1]),
                  ([-3, -1, -1], [0, 0, 0])):
        t_out = types.np_bbox(*outer, device=DEVICE)
        t_in = types.np_bbox(*inner, device=DEVICE)
        j_out, j_in = jtypes.np_bbox(*outer), jtypes.np_bbox(*inner)
        assert bool(t_out.contains(t_in)) == bool(j_out.contains(j_in))
        assert float(t_out.distance_outside(t_in)) == float(
            j_out.distance_outside(j_in))
        np.testing.assert_array_equal(t_in.center.numpy(),
                                      np.asarray(j_in.center))
    mats = rng.standard_normal((4, 4, 4)).astype(np.float32)
    tc = types.Camera(*(torch.from_numpy(m) for m in mats[:3]),
                      torch.tensor(45.0))
    jc = jtypes.Camera(*(jnp.asarray(m) for m in mats[:3]), jnp.float32(45))
    np.testing.assert_allclose(tc.mvp.numpy(), np.asarray(jc.mvp), atol=1e-5)
    np.testing.assert_allclose(tc.modelview.numpy(),
                               np.asarray(jc.modelview), atol=1e-5)
    te, je = types.make_empty_mesh(DEVICE), jtypes.make_empty_mesh()
    _mesh_equal(te, je)
    assert te.num_faces == je.num_faces == 0


def test_transform_points_and_dirs():
    rng = np.random.default_rng(1)
    Ts = np.stack([np.asarray(jse3.exp_se3(jnp.asarray(
        rng.normal(0, 0.5, 6).astype(np.float32)))) for _ in range(4)])
    p = rng.uniform(-3, 3, (4, 30, 3)).astype(np.float32)
    for T, pts in ((Ts[0], p[0]), (Ts[1], p)):
        for tf, jf in ((se3.transform_points, jse3.transform_points),
                       (se3.transform_dirs, jse3.transform_dirs)):
            np.testing.assert_allclose(
                tf(torch.from_numpy(np.ascontiguousarray(T)),
                   torch.from_numpy(np.ascontiguousarray(pts))).numpy(),
                np.asarray(jf(jnp.asarray(T), jnp.asarray(pts))), atol=1e-6)
    # a direction ignores the translation
    d = se3.transform_dirs(torch.from_numpy(Ts[0]), torch.from_numpy(p[0]))
    q = se3.transform_points(torch.from_numpy(Ts[0]), torch.from_numpy(p[0]))
    np.testing.assert_allclose((q - d).numpy(),
                               np.broadcast_to(Ts[0][:3, 3], (30, 3)),
                               atol=1e-5)


@pytest.mark.parametrize("eye,center,fov,aspect", [
    ((1.5, 1.2, 2.0), (0.0, 0.0, 0.0), 45.0, 4 / 3),
    ((-0.3, 2.2, 0.9), (0.1, -0.2, 0.3), 70.0, 1.0),
])
def test_camera_builders(eye, center, fov, aspect):
    ti = camera.intrinsics_from_fov(640, 480, 58.0, 45.0)
    ji = jcamera.intrinsics_from_fov(640, 480, 58.0, 45.0)
    assert tuple(ti) == tuple(float(x) for x in ji)
    tc = camera.make_camera(eye, center, (0.0, 1.0, 0.0), fov, aspect,
                            device=DEVICE)
    jc = jcamera.make_camera(eye, center, (0.0, 1.0, 0.0), fov, aspect)
    for name in ("model", "view", "projection"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), atol=1e-6)
    assert float(tc.fov) == float(jc.fov)
    np.testing.assert_allclose(
        camera.perspective(fov, aspect, 0.1, 50.0, device=DEVICE).numpy(),
        np.asarray(jcamera.perspective(fov, aspect, 0.1, 50.0)), atol=1e-6)


OBJ_TEXTS = pytest.mark.parametrize(
    "text", [CUBE_OBJ, NEG_OBJ, COLOR_OBJ],
    ids=["cube_vt", "neg_vn_fan", "colors"])


@OBJ_TEXTS
def test_load_obj_matches_reference_parser(tmp_path, text):
    """The port's Python parser against the reference's, whatever route
    the public load_obj takes on this host."""
    path = tmp_path / "m.obj"
    path.write_text(text)
    t = obj._load_obj_py(str(path), device=DEVICE)
    j = jobj._load_obj_py(str(path))
    _mesh_equal(t, j)
    assert t.num_faces == j.num_faces


@OBJ_TEXTS
def test_load_obj_matches_reference_public(tmp_path, text):
    """The public load_obj of both packages: the native parser where the
    runtime builds and the file has no vertex colours, else the Python
    one."""
    path = tmp_path / "m.obj"
    path.write_text(text)
    t = obj.load_obj(str(path), device=DEVICE)
    j = jobj.load_obj(str(path))
    _mesh_equal(t, j)
    assert t.num_faces == j.num_faces


def test_obj_round_trip(tmp_path):
    """A seeded mesh with colours and normals through both writers and
    both readers: the files are the same text and read back the same."""
    rng = np.random.default_rng(2)
    nv, nf = 40, 60
    v = rng.uniform(-1, 1, (nv, 3)).astype(np.float32)
    n = rng.normal(0, 1, (nv, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    c = rng.uniform(0, 1, (nv, 3)).astype(np.float32)
    f = rng.integers(0, nv, (nf, 3)).astype(np.int32)
    uv = np.zeros((nf, 3, 2), np.float32)
    tm = types.Mesh(*(torch.from_numpy(x) for x in (v, n, c, f, uv)),
                    bbox=types.np_bbox(v.min(0), v.max(0), device=DEVICE))
    jm = jtypes.Mesh(*(jnp.asarray(x) for x in (v, n, c, f, uv)),
                     bbox=jtypes.np_bbox(v.min(0), v.max(0)))
    tp, jp = tmp_path / "t.obj", tmp_path / "j.obj"
    obj.save_obj(str(tp), tm)
    jobj.save_obj(str(jp), jm)
    assert tp.read_text() == jp.read_text()
    back = obj.load_obj(str(tp), device=DEVICE)
    _mesh_equal(back, jobj.load_obj(str(jp)))
    _mesh_equal(obj._load_obj_py(str(tp), device=DEVICE),
                jobj._load_obj_py(str(jp)))
    np.testing.assert_allclose(back.vertices.numpy(), v, atol=1e-6)
    np.testing.assert_allclose(back.colors.numpy(), c, atol=1e-4)
    np.testing.assert_array_equal(back.faces.numpy(), f)
    # without normals and colours the writer emits plain 'v' and 'f'
    bare = tm._replace(normals=tm.normals[:0], colors=tm.colors[:0])
    jbare = jm._replace(normals=jm.normals[:0], colors=jm.colors[:0])
    obj.save_obj(str(tp), bare)
    jobj.save_obj(str(jp), jbare)
    assert tp.read_text() == jp.read_text()
    _mesh_equal(obj.load_obj(str(tp), device=DEVICE),
                jobj.load_obj(str(jp)))
    _mesh_equal(obj._load_obj_py(str(tp), device=DEVICE),
                jobj._load_obj_py(str(jp)))


def _bmp_bytes(rgb, bpp=24, top_down=False, compression=0, masks=None,
               alpha=200):
    """A BMP file of u8[H, W, 3] with the given layout."""
    h, w, _ = rgb.shape
    ch = bpp // 8
    px = rgb[..., ::-1]
    if ch == 4:
        px = np.concatenate([px, np.full((h, w, 1), alpha, np.uint8)], -1)
    if ch not in (3, 4):
        px = np.zeros((h, w, ch), np.uint8)
    row_bytes = (w * ch + 3) & ~3
    rows = np.zeros((h, row_bytes), np.uint8)
    rows[:, : w * ch] = (px if top_down else px[::-1]).reshape(h, w * ch)
    extra = struct.pack("<III", *masks) if masks else b""
    offset = 54 + len(extra)
    head = struct.pack("<2sIHHI", b"BM", offset + rows.size, 0, 0, offset)
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp,
                       compression, rows.size, 2835, 2835, 0, 0)
    return head + info + extra + rows.tobytes()


def test_load_bmp_layouts(tmp_path):
    """24- and 32-bit, bottom-up and top-down rows, BGRA bitfields."""
    rgb = np.random.default_rng(3).integers(0, 256, (5, 7, 3)).astype(
        np.uint8)  # width 7: 24-bit rows are padded
    bgra = (0x00FF0000, 0x0000FF00, 0x000000FF)
    for bpp, top_down, compression, masks in (
            (24, False, 0, None), (24, True, 0, None), (32, False, 0, None),
            (32, True, 3, bgra)):
        path = tmp_path / f"t{bpp}{int(top_down)}.bmp"
        path.write_bytes(_bmp_bytes(rgb, bpp, top_down, compression, masks))
        t = bmp.load_bmp(str(path), device=DEVICE)
        j = jbmp.load_bmp(str(path))
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        np.testing.assert_array_equal(t.data.numpy(),
                                      rgb.astype(np.float32) / 255.0)


def test_save_bmp_reads_back(tmp_path):
    rgb = np.random.default_rng(4).integers(0, 256, (6, 9, 3)).astype(
        np.uint8)
    path = str(tmp_path / "s.bmp")
    bmp.save_bmp(path, rgb)
    np.testing.assert_array_equal(np.asarray(jbmp.load_bmp(path).data),
                                  rgb.astype(np.float32) / 255.0)


def test_load_bmp_refusals(tmp_path):
    """Not a BMP, 16 bits, RLE and RGBA masks: the reference's errors."""
    rgb = np.zeros((2, 3, 3), np.uint8)
    for data in (b"PK" + _bmp_bytes(rgb)[2:], _bmp_bytes(rgb, bpp=16),
                 _bmp_bytes(rgb, compression=1),
                 _bmp_bytes(rgb, bpp=32, compression=3,
                            masks=(0xFF, 0xFF00, 0xFF0000))):
        path = tmp_path / "bad.bmp"
        path.write_bytes(data)
        with pytest.raises(ValueError) as je:
            jbmp.load_bmp(str(path))
        with pytest.raises(ValueError) as te:
            bmp.load_bmp(str(path), device=DEVICE)
        assert str(te.value) == str(je.value)


def test_rpe_matches_reference():
    rng = np.random.default_rng(5)
    gt = np.stack([np.asarray(jse3.exp_se3(jnp.asarray(
        rng.normal(0, 0.3, 6).astype(np.float32)))) for _ in range(8)])
    est = gt.copy()
    est[:, :3, 3] += rng.normal(0, 0.01, (8, 3)).astype(np.float32)
    for delta in (1, 3):
        t = metrics.rpe(est, gt, delta=delta)
        j = jmetrics.rpe(est, gt, delta=delta)
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-12)
    assert metrics.rpe(gt, gt)[0] < 1e-6
