"""Port parity for scene.py, render/renderer.py and the CLI's --save-mesh:
two meshes with a texture each (BMP and PNG), voxelized alone and into the
octree, a point cloud that makes the octree and then expands it, every
Renderer method, and the map exported by --save-mesh after a small orbit.

Tolerances: voxel grids of the meshes equal word for word; through the
octree the occupied set and the centres equal and colours within one
8-bit level; rasterized images as in
test_torch_raster.py; the cone and splat views within 1e-4 on 99% of
pixels; the exported OBJ the same text as the JAX package's save_obj of
voxel_grid_to_mesh of the same extraction."""

import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import DEVICE, close_share, port_config

from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu.core import camera as jcamera
from octree_slam_tpu.core.types import BoundingBox as JBox
from octree_slam_tpu.core.types import VoxelGrid as JGrid
from octree_slam_tpu.io import obj as jobj
from octree_slam_tpu.map import voxelization as jvox
from octree_slam_tpu.render.renderer import Renderer as JRenderer
from octree_slam_tpu.scene import Scene as JScene
from octree_slam_tpu_torch import app
from octree_slam_tpu_torch.core import camera
from octree_slam_tpu_torch.io import bmp, png
from octree_slam_tpu_torch.map import svo, tiering
from octree_slam_tpu_torch.render.renderer import Renderer
from octree_slam_tpu_torch.scene import Scene

CFG = SLAMConfig(vox_log_n=5, vox_tri_budget=64, voxel_resolution=0.05,
                 node_capacity=1 << 15, extract_capacity=1 << 12)
W, H = 64, 48
CUBE = """\
v {x0} -0.5 -0.5
v {x1} -0.5 -0.5
v {x1} 0.5 -0.5
v {x0} 0.5 -0.5
v {x0} -0.5 0.5
v {x1} -0.5 0.5
v {x1} 0.5 0.5
v {x0} 0.5 0.5
vt 0 0
vt 1 0
vt 1 1
vt 0 1
f 1/1 2/2 3/3
f 1/1 3/3 4/4
f 5/1 7/3 6/2
f 5/1 8/4 7/3
f 1/1 5/2 6/3
f 1/1 6/3 2/4
f 2/1 6/2 7/3
f 2/1 7/3 3/4
f 3/1 7/2 8/3
f 3/1 8/3 4/4
f 4/1 8/2 5/3
f 4/1 5/3 1/4
"""


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("assets")
    rng = np.random.default_rng(0)
    paths = {}
    for name, (x0, x1) in (("a", (-2.0, -1.0)), ("b", (1.0, 1.7))):
        paths[name] = str(d / f"{name}.obj")
        open(paths[name], "w").write(CUBE.format(x0=x0, x1=x1))
    paths["bmp"] = str(d / "a.bmp")
    bmp.save_bmp(paths["bmp"], rng.integers(0, 256, (8, 12, 3)))
    paths["png"] = str(d / "b.png")
    png.write_png(paths["png"], rng.integers(0, 256, (9, 7, 3)).astype(
        np.uint8))
    return paths


def _scenes(assets, textured=True):
    js, ts = JScene(CFG), Scene(port_config(CFG), device=DEVICE)
    for s in (js, ts):
        s.load_obj_file(assets["a"])
        if textured:
            s.load_texture(assets["bmp"])
        s.load_obj_file(assets["b"])
        if textured:
            s.load_texture(assets["png"])
    return js, ts


def _grid_eq(t, j, exact_colors=True):
    n = int(j.count)
    assert int(t.count) == n > 0
    np.testing.assert_array_equal(t.centers.numpy(), np.asarray(j.centers))
    if exact_colors:
        np.testing.assert_array_equal(t.colors.numpy(), np.asarray(j.colors))
    else:
        np.testing.assert_allclose(t.colors.numpy(), np.asarray(j.colors),
                                   atol=1 / 255 + 1e-6)
    assert float(t.scale) == float(j.scale)


def test_textures_pair_with_meshes(assets, monkeypatch):
    js, ts = _scenes(assets)
    assert len(ts.textures) == len(js.textures) == 2
    for t, j in zip(ts.textures, js.textures):
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    # a texture before any mesh takes slot 0; one after two untextured
    # meshes pads slot 0 with None
    js2, ts2 = JScene(CFG), Scene(port_config(CFG), device=DEVICE)
    for s in (js2, ts2):
        s.load_obj_file(assets["a"])
        s.load_obj_file(assets["b"])
        s.load_texture(assets["png"])
    assert ts2.textures[0] is None and js2.textures[0] is None
    # a format other than BMP and PNG is read through PIL; without PIL
    # the error names the format
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match="'jpg'.*PIL"):
        ts2.load_texture(assets["png"][:-3] + "jpg")


@pytest.mark.parametrize("textured", [True, False])
@pytest.mark.parametrize("conservative", [False, True],
                         ids=["thin", "conservative"])
def test_voxelize_meshes(assets, textured, conservative):
    js, ts = _scenes(assets, textured)
    _grid_eq(ts.voxelize_meshes(conservative=conservative),
             js.voxelize_meshes(conservative=conservative))
    # one mesh: its own box
    j1, t1 = JScene(CFG), Scene(port_config(CFG), device=DEVICE)
    for s in (j1, t1):
        s.load_obj_file(assets["b"])
        if textured:
            s.load_texture(assets["png"])
    _grid_eq(t1.voxelize_meshes(conservative=conservative),
             j1.voxelize_meshes(conservative=conservative))


def test_voxelize_into_octree_and_render(assets):
    js, ts = _scenes(assets)
    jg = js.voxelize_meshes(octree=True)
    tg = ts.voxelize_meshes(octree=True)
    _grid_eq(tg, jg, exact_colors=False)
    assert ts.tree.max_depth == js.tree.max_depth
    np.testing.assert_array_equal(ts.tree.center, js.tree.center)
    _grid_eq(ts.extract_voxel_grid_from_octree(),
             js.extract_voxel_grid_from_octree(), exact_colors=False)
    jpool, tpool = js.svo(), ts.svo()
    assert int(tpool.n_nodes) == int(jpool.n_nodes)

    jr, tr = JRenderer(W, H), Renderer(W, H)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.0, 0.0, -4.5]
    fx = 50.0
    jf = np.asarray(jr.cone_trace_svo(jpool, jnp.asarray(pose), fx, fx,
                                      ts.tree.max_depth))
    tf = tr.cone_trace_svo(tpool, torch.from_numpy(pose), fx, fx,
                           ts.tree.max_depth).numpy()
    assert (jf[..., 3] > 0).mean() > 0.02
    assert close_share(tf, jf) >= 0.99

    eye, at = (0.4, 1.5, 4.0), (0.0, 0.0, 0.0)
    jc = jcamera.make_camera(eye, at, (0.0, 1.0, 0.0), 55.0, W / H)
    tc = camera.make_camera(eye, at, (0.0, 1.0, 0.0), 55.0, W / H,
                            device=DEVICE)
    for use_cubes in (False, True):
        a = np.asarray(jr.rasterize_voxels(jg, jc, use_cubes=use_cubes))
        b = tr.rasterize_voxels(tg, tc, use_cubes=use_cubes).numpy()
        np.testing.assert_array_equal(b[..., 3], a[..., 3])
        assert a[..., 3].mean() > 0.05
        np.testing.assert_allclose(b[..., :3], a[..., :3], atol=1 / 255 + 1e-5)


def test_renderer_mesh_views(assets):
    js, ts = _scenes(assets)
    eye = (0.4, 1.5, 4.0)
    jc = jcamera.make_camera(eye, (0, 0, 0), (0, 1, 0), 55.0, W / H)
    tc = camera.make_camera(eye, (0, 0, 0), (0, 1, 0), 55.0, W / H,
                            device=DEVICE)
    jr, tr = JRenderer(W, H), Renderer(W, H)
    for k in range(2):
        a = np.asarray(jr.rasterize(js.meshes[k], jc, js.textures[k]))
        b = tr.rasterize(ts.meshes[k], tc, ts.textures[k]).numpy()
        np.testing.assert_array_equal(b[..., 3], a[..., 3])
        assert a[..., 3].sum() > 50
        np.testing.assert_allclose(b[..., :3], a[..., :3], atol=1e-5)
        np.testing.assert_array_equal(
            tr.rasterize_wireframe(ts.meshes[k], tc).numpy(),
            np.asarray(jr.rasterize_wireframe(js.meshes[k], jc)))
        np.testing.assert_array_equal(
            tr.rasterize_vertices(ts.meshes[k], tc).numpy(),
            np.asarray(jr.rasterize_vertices(js.meshes[k], jc)))
    rng = np.random.default_rng(1)
    vmap = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
    col = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    np.testing.assert_array_equal(
        tr.render_points(torch.from_numpy(vmap), torch.from_numpy(col),
                         tc).numpy(),
        np.asarray(jr.render_points(jnp.asarray(vmap), jnp.asarray(col),
                                    jc)))
    np.testing.assert_allclose(
        tr.pixel_passthrough(torch.from_numpy(col)).numpy(),
        np.asarray(jr.pixel_passthrough(jnp.asarray(col))), atol=1e-7)


def test_point_cloud_creates_then_expands():
    cfg = SLAMConfig(voxel_resolution=0.05, node_capacity=1 << 15,
                     extract_capacity=1 << 10)
    js, ts = JScene(cfg), Scene(port_config(cfg), device=DEVICE)
    rng = np.random.default_rng(2)
    near = rng.uniform(0.0, 0.5, (200, 3)).astype(np.float32)
    far = rng.uniform(2.5, 3.0, (50, 3)).astype(np.float32)
    for pts in (near, far):
        cols = rng.uniform(0, 1, pts.shape).astype(np.float32)
        js.add_point_cloud_to_octree(jnp.zeros(3), jnp.asarray(pts),
                                     jnp.asarray(cols))
        ts.add_point_cloud_to_octree(torch.zeros(3), torch.from_numpy(pts),
                                     torch.from_numpy(cols))
        assert ts.tree.size == js.tree.size
        assert ts.tree.max_depth == js.tree.max_depth
        np.testing.assert_array_equal(ts.tree.center, js.tree.center)
        # each point seen once: a leaf's alpha stays at 129, occupied
        _grid_eq(ts.extract_voxel_grid_from_octree(),
                 js.extract_voxel_grid_from_octree(), exact_colors=False)
    assert ts.tree.contains(ts.tree.bounding_box())
    with pytest.raises(ValueError, match="no octree"):
        Scene(port_config(cfg), device=DEVICE).svo()


ORBIT = ["--frames", "3", "--width", "80", "--height", "60", "--max-depth",
         "7", "--resolution", "0.03", "--log-every", "0", "--device", "cpu"]


def test_save_mesh_writes_the_reference_mesh(tmp_path, capsys):
    """--save-mesh after a 3-frame orbit: the file is the JAX package's
    save_obj of its voxel_grid_to_mesh of the same extraction."""
    path = str(tmp_path / "map.obj")
    sink = []
    res = app.main(ORBIT + ["--save-mesh", path])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["frames"] == 3 and not rec["diverged"]
    # the same run again, for its state (the CPU run is deterministic)
    from octree_slam_tpu_torch import SLAMConfig as PortConfig
    from octree_slam_tpu_torch.sensor import sources
    cfg = PortConfig(width=80, height=60, max_depth=7, voxel_resolution=0.03)
    scene = sources.default_scene(DEVICE)
    gt = [sources.orbit_pose(i * 0.01, radius=2.0, device=DEVICE)
          for i in range(3)]
    res2 = app.run_slam(lambda i: sources.render_frame(
        scene, gt[i], cfg.focal_x, cfg.focal_y, width=80, height=60), 3, cfg,
        initial_pose=gt[0], render_every=1, state_out=sink, device=DEVICE)
    np.testing.assert_array_equal(np.stack(res2.poses), np.stack(res.poses))
    st, fcfg = sink[0], res2.final_cfg
    pool = svo.refresh_interior(st.pool, depth=fcfg.max_depth)
    ex, _ = svo.extract_all_leaves(pool, depth=fcfg.max_depth,
                                   start_capacity=fcfg.extract_capacity)
    n = int(ex.count)
    assert n > 50
    c = pool.center.numpy()
    h = float(pool.half_size)
    grid = JGrid(jnp.asarray(ex.centers[:n].numpy()),
                 jnp.asarray(ex.colors[:n].numpy()), jnp.int32(n),
                 fcfg.voxel_resolution / 2.0,
                 JBox(jnp.asarray(c - h), jnp.asarray(c + h)))
    ref = str(tmp_path / "ref.obj")
    jobj.save_obj(ref, jvox.voxel_grid_to_mesh(grid))
    assert open(path).read() == open(ref).read()
    mesh = jobj._load_obj_py(path)
    assert mesh.vertices.shape[0] == 8 * n and mesh.faces.shape[0] == 12 * n

    # leaves in the host archive are exported too
    arch = tiering.HostArchive(level=2)
    keys = ex.keys[:5].numpy().copy()
    vals = np.full(5, 0xC8204080, np.uint32)
    arch.add(0, keys, vals)
    out = str(tmp_path / "arch.obj")
    assert app.export_mesh(out, st, fcfg, arch) == n + 5
    assert len(arch) == 0
    text = open(out).read().splitlines()
    assert sum(line.startswith("v ") for line in text) == 8 * (n + 5)
    assert text[1 + 8 * n].endswith("0.5020 0.2510 0.1255")
