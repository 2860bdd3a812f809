"""The offline paths on the card against the port itself on the CPU: the
dense voxel grid (THIN and CONSERVATIVE, textured) and the A-buffer of a
seeded triangle soup, the triangle rasterizer on a voxel-cube mesh whose
faces tie in depth, and the packed point and voxel-splat z-buffers. Then
the offline paths at the reference's full size on an in-code sphere and
torus of 100,000 triangles with a 256x256 checker, written with the
port's OBJ and BMP writers and read back through Scene: the 256^3 grid,
the A-buffer, a palette PNG texture, the octree and the 640x480 views; the
same mesh reduced to 2,048 triangles card against CPU; and the CLI's
--save-mesh after the benchmark orbit.
Marked `cuda`: without a CUDA device every test skips. The repository's
conftest imports jax, which the card's machine lacks, so run these there
with

    python -m pytest tests/test_torch_cuda_offline.py --noconftest -q

Tolerances: grids, A-buffers and z-buffer words equal word for word; the
rasterized coverage equal on every pixel (the multiply-adds that decide it
are float64 on both devices) and colours within 1e-5, the parity tests'
bound: the shading is plain float32, and its normalisations (a reduction
each) and the Phong power of 32 round differently on the two devices (the
card's largest difference read 1.7e-6). At full size: two voxelizations
equal word for word, THIN inside CONSERVATIVE, the A-buffer's occupied
set the grid's, every view covering more than 1% of its pixels; the
reduced mesh's grid, A-buffer and cube raster card against CPU word for
word."""

import dataclasses

import numpy as np
import pytest
import torch

import png_encoder
import torch_orbit as orb
from octree_slam_tpu_torch import SLAMConfig
from octree_slam_tpu_torch.core.types import BoundingBox, Mesh, VoxelGrid
from octree_slam_tpu_torch.core import camera
from octree_slam_tpu_torch.io import bmp
from octree_slam_tpu_torch.map import morton
from octree_slam_tpu_torch.map import voxelization as vox
from octree_slam_tpu_torch.render import points, raster
from octree_slam_tpu_torch.render.renderer import Renderer
from octree_slam_tpu_torch.scene import Scene
from octree_slam_tpu_torch.sensor import cuda_ops
from octree_slam_tpu_torch.utils import compaction

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these hold the card against the "
                    "CPU")
    return torch.device("cuda", 0)


def _soup(n=400, seed=0):
    rng = np.random.default_rng(seed)
    v = (rng.uniform(-0.8, 0.8, (n, 1, 3))
         + rng.normal(0, 0.1, (n, 3, 3))).reshape(-1, 3).astype(np.float32)
    return Mesh(torch.from_numpy(v), torch.zeros(v.shape),
                torch.ones(v.shape),
                torch.arange(3 * n, dtype=torch.int32).reshape(n, 3),
                torch.from_numpy(rng.uniform(0, 1, (n, 3, 2))
                                 .astype(np.float32)),
                BoundingBox(torch.full((3,), -1.0), torch.full((3,), 1.0)))


def _to(mesh, dev):
    return Mesh(*(x.to(dev) for x in mesh[:5]),
                bbox=BoundingBox(mesh.bbox.bbox0.to(dev),
                                 mesh.bbox.bbox1.to(dev)))


@pytest.mark.parametrize("conservative", [False, True],
                         ids=["thin", "conservative"])
def test_grid_and_abuffer_card_vs_cpu(device, conservative, monkeypatch):
    monkeypatch.setattr(compaction, "CHUNK_LANES", 256 * 61)
    mesh = _soup()
    tex = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (32, 48, 3)).astype(np.float32))
    out = {}
    for dev in ("cpu", device):
        m = _to(mesh, dev)
        soup = vox.prepare_mesh(m, m.bbox, 6, 256)
        grid = vox.voxelize(soup, tex.to(dev), m.bbox.bbox0, m.bbox.bbox1,
                            log_n=6, tri_budget=256,
                            conservative=conservative)
        ab = vox.voxelize_abuffer(soup, m.bbox.bbox0, m.bbox.bbox1, log_n=6,
                                  tri_budget=256, capacity=1 << 14,
                                  conservative=conservative)
        out[str(dev)] = [grid.cpu()] + [x.cpu() for x in ab]
    cpu, card = out["cpu"], out[str(device)]
    for a, b in zip(cpu, card):
        assert torch.equal(a, b)
    assert int((cpu[0] != 0).sum()) > 1000


def _cube_mesh(dev, seed=1):
    rng = np.random.default_rng(seed)
    cen = np.stack(np.meshgrid(*[np.arange(-3, 4)] * 3, indexing="ij"),
                   -1).reshape(-1, 3).astype(np.float32) * 0.2
    cen = cen[rng.random(len(cen)) < 0.5]
    cols = rng.uniform(0, 1, (len(cen), 4)).astype(np.float32)
    grid = VoxelGrid(torch.from_numpy(cen).to(dev),
                     torch.from_numpy(cols).to(dev),
                     torch.tensor(len(cen)), torch.tensor(0.1),
                     BoundingBox(torch.zeros(3), torch.ones(3)))
    return vox.voxel_grid_to_mesh(grid)


@pytest.mark.parametrize("shading", ["color", "phong"])
def test_rasterize_ties_card_vs_cpu(device, shading, monkeypatch):
    monkeypatch.setattr(compaction, "CHUNK_LANES", 512 * 97)
    # one camera for both: its matrices are built on the host
    mvp = camera.make_camera((1.8, 1.4, 2.4), (0, 0, 0), (0, 1, 0), 50.0,
                             4 / 3, device="cpu").mvp
    out = []
    for dev in ("cpu", device):
        rm = raster.assemble(_cube_mesh(dev))
        out.append(raster.rasterize(
            rm, mvp.to(dev), width=160, height=120, frag_budget=512,
            shading=shading, cull_backfaces=False).cpu())
    a, b = out
    assert torch.equal(a[..., 3], b[..., 3]) and a[..., 3].sum() > 2000
    assert float((a[..., :3] - b[..., :3]).abs().max()) <= 1e-5


def test_points_and_voxels_card_vs_cpu(device):
    rng = np.random.default_rng(2)
    pts = torch.from_numpy(rng.uniform(-1, 1, (5000, 3)).astype(np.float32))
    cols = torch.from_numpy(rng.uniform(0, 1, (5000, 3)).astype(np.float32))
    live = torch.from_numpy(rng.random(5000) < 0.8)
    cam = camera.make_camera((1.1, 0.7, 1.6), (0, 0, 0), (0, 1, 0), 50.0,
                             4 / 3, device="cpu")
    words = []
    for dev in ("cpu", device):
        args = (pts.to(dev), cols.to(dev))
        view, mvp = cam.view.to(dev), cam.mvp.to(dev)
        words.append([
            points.points_zbuffer(*args, mvp, width=160, height=120).cpu(),
            points.voxels_zbuffer(*args, 0.02, live.to(dev), view, mvp,
                                  width=160, height=120,
                                  proj_focal=cam.projection[1, 1]).cpu()])
    for a, b in zip(*words):
        assert torch.equal(a, b)
        assert int((a != points.DEPTH_INF).sum()) > 1000


# ---------------------------------------------------------------- full size

# the reference's offline configuration: a 256^3 grid, 512 triangles a
# tile
OFFLINE = SLAMConfig(vox_log_n=8, vox_tri_budget=512,
                     extract_capacity=1 << 20, node_capacity=1 << 21)


def _uv_surface(pos_fn, nrm_fn, nu, nv, u_max, v_max):
    """A parametric surface as a (nu+1) x (nv+1) vertex grid (the seam
    repeated, so each vertex has one uv) and 2 * nu * nv triangles."""
    u = np.linspace(0.0, u_max, nu + 1)
    v = np.linspace(0.0, v_max, nv + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    verts = pos_fn(uu, vv).reshape(-1, 3)
    nrms = nrm_fn(uu, vv).reshape(-1, 3)
    uv = np.stack([uu / u_max, vv / v_max], -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = (i * (nv + 1) + j).reshape(-1)
    b, c, e = a + nv + 1, a + nv + 2, a + 1
    faces = np.concatenate([np.stack([a, b, c], -1), np.stack([a, c, e], -1)])
    return verts, nrms, uv, faces


def _sphere_and_torus(n_sphere, n_torus):
    """A UV sphere beside a torus: f32 vertices, normals, i32 faces and
    per-corner uv; 2 * nu * nv triangles each."""
    def sphere(t, p):
        return np.stack([np.sin(p) * np.cos(t), np.cos(p),
                         np.sin(p) * np.sin(t)], -1)

    def torus(t, p):
        ring = 0.34 + 0.14 * np.cos(p)
        return np.stack([ring * np.cos(t), 0.14 * np.sin(p),
                         ring * np.sin(t)], -1)

    def torus_n(t, p):
        return np.stack([np.cos(p) * np.cos(t), np.sin(p),
                         np.cos(p) * np.sin(t)], -1)

    sv, sn, suv, sf = _uv_surface(lambda t, p: 0.42 * sphere(t, p)
                                  + [-0.48, 0.0, 0.0], sphere,
                                  *n_sphere, 2 * np.pi, np.pi)
    tv, tn, tuv, tf = _uv_surface(lambda t, p: torus(t, p)
                                  + [0.52, 0.05, 0.1],
                                  torus_n, *n_torus, 2 * np.pi, 2 * np.pi)
    faces = np.concatenate([sf, tf + len(sv)]).astype(np.int32)
    uv = np.concatenate([suv, tuv]).astype(np.float32)
    return (np.concatenate([sv, tv]).astype(np.float32),
            np.concatenate([sn, tn]).astype(np.float32), faces, uv[faces])


def _checker(size=256, block=32):
    y, x = np.mgrid[:size, :size]
    on = ((x // block + y // block) % 2).astype(bool)
    rgb = np.stack([np.where(on, 230, 40 + x // 2), np.where(on, 60, 200),
                    np.where(on, 30 + y // 2, 90)], -1)
    return rgb.astype(np.uint8)


def _write_assets(d, name, n_sphere, n_torus):
    """The mesh as a textured OBJ ('v' and 'vn' lines a vertex, a 'vt'
    line a face corner, faces as v/vt/vn) and the checker through the
    port's BMP writer: (obj path, bmp path, faces)."""
    v, n, f, uv = _sphere_and_torus(n_sphere, n_torus)
    obj, tex = str(d / f"{name}.obj"), str(d / f"{name}.bmp")
    f1 = f.astype(np.int64) + 1
    t1 = np.arange(1, 3 * len(f) + 1).reshape(-1, 3)
    with open(obj, "w") as out:
        for fmt, rows in (("v %.6f %.6f %.6f", v),
                          ("vt %.6f %.6f", uv.reshape(-1, 2)),
                          ("vn %.6f %.6f %.6f", n),
                          ("f %d/%d/%d %d/%d/%d %d/%d/%d",
                           np.stack([f1, t1, f1], -1).reshape(-1, 9))):
            out.write("\n".join(fmt % tuple(r) for r in rows.tolist()))
            out.write("\n")
    bmp.save_bmp(tex, _checker())
    return obj, tex, len(f)


def test_full_size_mesh_voxelizes_and_renders(device, tmp_path):
    """These paths reach no hand kernel."""
    cuda_ops.reset_launches()
    obj, tex_path, n_tri = _write_assets(tmp_path, "full", (250, 100),
                                         (250, 100))
    assert n_tri == 100_000
    scene = Scene(OFFLINE, device="cuda")
    mesh = scene.load_obj_file(obj)
    tex = scene.load_texture(tex_path)
    assert mesh.faces.shape[0] == n_tri
    lo, hi = mesh.bbox
    kw = dict(log_n=8, tri_budget=512)
    soup = vox.prepare_mesh(mesh, mesh.bbox, 8, 512)
    grid = vox.voxelize(soup, tex.data, lo, hi, **kw)
    assert torch.equal(grid, vox.voxelize(soup, tex.data, lo, hi, **kw))
    occ = grid.reshape(-1) != 0
    cons = vox.voxelize(soup, tex.data, lo, hi, conservative=True, **kw)
    assert not bool((occ & (cons.reshape(-1) == 0)).any())
    del cons
    ab = vox.voxelize_abuffer(soup, lo, hi, capacity=1 << 23, **kw)
    assert not bool(ab.overflowed)
    assert torch.equal(torch.unique_consecutive(ab.frag_voxel[:int(ab.count)]),
                       torch.nonzero(occ).squeeze(1).to(torch.int32))
    del ab

    # a 16-colour palette PNG through the port's codec, against the same
    # texture stored as RGB8; both written by the tests' encoder (random
    # row filters), not by the codec under test
    y, x = np.mgrid[:256, :256]
    idx = ((x // 32 + 3 * (y // 32)) % 16).astype(np.uint8)
    pal = np.random.default_rng(6).integers(0, 256, (16, 3)).astype(np.uint8)
    pal_png, rgb_png = str(tmp_path / "pal.png"), str(tmp_path / "rgb.png")
    png_encoder.write_png(pal_png, idx, 8, 3, palette=pal, seed=1)
    png_encoder.write_png(rgb_png, pal[idx], 8, 2, seed=2)
    ptex = Scene(OFFLINE, device="cuda").load_texture(pal_png)
    rtex = Scene(OFFLINE, device="cuda").load_texture(rgb_png)
    assert torch.equal(ptex.data, rtex.data)
    pgrid = vox.voxelize(soup, ptex.data, lo, hi, **kw)
    assert torch.equal(pgrid, vox.voxelize(soup, rtex.data, lo, hi, **kw))
    assert int((pgrid != 0).sum()) > 0
    del pgrid, grid, soup

    cells = scene.voxelize_meshes(octree=False)
    again = scene.voxelize_meshes(octree=False)
    for a, b in zip(cells[:3], again[:3]):
        assert torch.equal(a, b)
    assert int(cells.count) == int(occ.sum())
    del cells, again

    # into the octree: each occupied grid cell lands in the leaf holding
    # its centre (several cells may share one: they are not cubes)
    vg = scene.voxelize_meshes(octree=True)
    g = scene.voxelize_meshes()
    keys, _ = morton.encode(g.centers[:int(g.count)], scene.tree.pool.center,
                            scene.tree.pool.half_size, scene.tree.max_depth)
    assert int(vg.count) == int(torch.unique(keys).numel())
    scene.voxel_grid = vg
    r = Renderer(640, 480)
    pose = torch.eye(4, device="cuda")
    pose[:3, 3] = torch.tensor([0.0, 0.0, -2.4])
    fb = r.cone_trace_svo(scene.svo(), pose, 525.0, 525.0,
                          scene.tree.max_depth)
    cover = {"cone_trace": float((fb[..., :3].amax(-1) > 0).float().mean())}
    cam = camera.make_camera((0.3, 0.9, 2.2), (0.0, 0.0, 0.0),
                             (0.0, 1.0, 0.0), 55.0, 4 / 3, device="cpu")
    cam = type(cam)(*(x.cuda() for x in cam))
    cover["raster"] = float(r.rasterize(mesh, cam, tex)[..., 3].mean())
    for cubes in (False, True):
        fb = r.rasterize_voxels(vg, cam, use_cubes=cubes)
        cover[f"voxels cubes={cubes}"] = float(fb[..., 3].mean())
    assert min(cover.values()) > 0.01, cover
    assert not any(cuda_ops.LAUNCHES.values())


def test_reduced_mesh_card_vs_cpu(device, tmp_path):
    """The mesh at 2,048 triangles into a 64^3 grid: grid, A-buffer and a
    160x120 rasterization of its voxel cubes, whose faces tie in depth,
    word for word."""
    obj, tex_path, n_tri = _write_assets(tmp_path, "small", (32, 16),
                                         (32, 16))
    assert n_tri == 2_048
    mvp = camera.make_camera((0.2, 1.1, 2.6), (0.0, 0.0, 0.0),
                             (0.0, 1.0, 0.0), 50.0, 4 / 3, device="cpu").mvp
    words = []
    for dev in ("cpu", device):
        s = Scene(dataclasses.replace(OFFLINE, vox_log_n=6), device=dev)
        m = s.load_obj_file(obj)
        t = s.load_texture(tex_path)
        sp = vox.prepare_mesh(m, m.bbox, 6, 512)
        g = vox.voxelize(sp, t.data, *m.bbox, log_n=6, tri_budget=512)
        a = vox.voxelize_abuffer(sp, *m.bbox, log_n=6, tri_budget=512,
                                 capacity=1 << 17)
        cubes = vox.voxel_grid_to_mesh(s.voxelize_meshes())
        fb = raster.rasterize(raster.assemble(cubes), mvp.to(dev),
                              width=160, height=120, frag_budget=64,
                              shading="color", cull_backfaces=False)
        words.append([x.cpu() for x in (g, *a, fb)])
    for a, b in zip(*words):
        assert torch.equal(a, b)
    assert int(words[0][-1][..., 3].sum()) > 1000


def test_cli_save_mesh_after_the_orbit(device, tmp_path):
    """The CLI's orbit with --save-mesh: 8 vertices and 12 faces a leaf of
    the pinned map, and one launch of each kernel a frame."""
    path = str(tmp_path / "map.obj")
    res, rec, launches = orb.run_cli(path)
    assert not res.diverged and rec["ate_rmse"] < 0.01
    nv = nf = 0
    with open(path) as f:
        for line in f:
            nv += line.startswith("v ")
            nf += line.startswith("f ")
    assert (nv, nf) == (8 * orb.ORBIT_MAP_LEAVES, 12 * orb.ORBIT_MAP_LEAVES)
    for name in orb.KERNELS:
        assert launches[name] == orb.ORBIT_FRAMES, name
