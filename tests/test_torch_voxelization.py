"""Port parity for map/voxelization.py: prepare_mesh's bisected soup, the
dense THIN and CONSERVATIVE grids, grid_to_voxel_list, mesh_to_voxel_grid
and voxel_grid_to_mesh, against the JAX package on a cube, a textured
quad, a seeded random soup and one triangle the budget bisects (the
A-buffer, the chunking and meshes_to_voxel_grid: test_torch_abuffer.py).

Tolerances: every array equal, word for word and bit for bit (the port
evaluates the reference's hit- and texel-deciding multiply-adds as XLA
fuses them; plain float32 rounding flips one texel word of the textured
quad at 32^3). Enumerating in chunks equals enumerating at once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (pins torch to one thread)
from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)

from octree_slam_tpu.core.types import BoundingBox as JBox
from octree_slam_tpu.core.types import Mesh as JMesh
from octree_slam_tpu.core.types import Texture as JTexture
from octree_slam_tpu.core.types import VoxelGrid as JGrid
from octree_slam_tpu.map import voxelization as jvox
from octree_slam_tpu_torch.core.types import BoundingBox, Mesh, Texture
from octree_slam_tpu_torch.map import voxelization as vox
from octree_slam_tpu_torch.utils import compaction

TEX = (np.round(np.random.default_rng(5).uniform(0, 1, (16, 24, 3)) * 255)
       / 255).astype(np.float32)
FLAT = np.ones((1, 1, 3), np.float32)


def _cube(h=0.6):
    v = np.array([[x, y, z] for z in (-h, h) for y in (-h, h)
                  for x in (-h, h)], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    f = np.array([t for q in quads for t in ((q[0], q[1], q[2]),
                                             (q[0], q[2], q[3]))], np.int32)
    return v, f, np.zeros((12, 3, 2), np.float32)


def _quad():
    v = np.array([[-.9, -.9, .03], [.9, -.9, .03], [.9, .9, .03],
                  [-.9, .9, .03]], np.float32)
    uv = np.array([[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]],
                  np.float32)
    return v, np.array([[0, 1, 2], [0, 2, 3]], np.int32), uv


def _soup(n=300, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.8, 0.8, (n, 1, 3))
    v = (c + rng.normal(0, 0.08, (n, 3, 3))).reshape(-1, 3).astype(
        np.float32)
    return (v, np.arange(3 * n, dtype=np.int32).reshape(n, 3),
            rng.uniform(0, 1, (n, 3, 2)).astype(np.float32))


def _big():
    v = np.array([[-0.95, -0.9, -0.7], [0.93, -0.2, 0.4],
                  [-0.3, 0.91, 0.85]], np.float32)
    return (v, np.array([[0, 1, 2]], np.int32),
            np.array([[[0, 0], [1, 0], [0.5, 1]]], np.float32))


SHAPES = {"cube": _cube, "quad": _quad, "soup": _soup, "big": _big}


def _meshes(name, lo=-1.0, hi=1.0):
    v, f, uv = SHAPES[name]()
    lo3, hi3 = np.full(3, lo, np.float32), np.full(3, hi, np.float32)
    j = JMesh(jnp.asarray(v), jnp.zeros(v.shape), jnp.zeros(v.shape),
              jnp.asarray(f), jnp.asarray(uv),
              JBox(jnp.asarray(lo3), jnp.asarray(hi3)))
    t = Mesh(torch.from_numpy(v), torch.zeros(v.shape), torch.zeros(v.shape),
             torch.from_numpy(f), torch.from_numpy(uv),
             BoundingBox(torch.from_numpy(lo3), torch.from_numpy(hi3)))
    return j, t


def _soups(name, log_n, budget, pad_to=None):
    j, t = _meshes(name)
    js = jvox.prepare_mesh(j, j.bbox, log_n, budget, pad_to=pad_to)
    ts = vox.prepare_mesh(t, t.bbox, log_n, budget, pad_to=pad_to)
    return j, t, js, ts


def _eq(t, j, what=""):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    b = np.asarray(j)
    if b.dtype == np.uint32:
        b = b.view(np.int32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_prepare_mesh_soup(name):
    for log_n, budget in ((5, 64), (6, 256)):
        _, _, js, ts = _soups(name, log_n, budget, pad_to=None)
        for field, a, b in zip(js._fields, ts, js):
            _eq(a, b, field)
        n = js.v0.shape[0]
        _, _, js, ts = _soups(name, log_n, budget, pad_to=n + 5)
        for field, a, b in zip(js._fields, ts, js):
            _eq(a, b, field)
        if name == "big":
            assert n > 50  # the budget bisected it


@pytest.mark.parametrize("name", sorted(SHAPES))
@pytest.mark.parametrize("conservative", [False, True],
                         ids=["thin", "conservative"])
def test_grid_bit_exact(name, conservative):
    """At 32^3 (budget 64) with the texture and the flat texel; the soup
    and the big triangle also at 64^3 (budget 256), where the bisection
    differs."""
    cases = [(5, 64, TEX), (5, 64, FLAT)]
    if name in ("soup", "big"):
        cases.append((6, 256, TEX))
    for log_n, budget, tex in cases:
        j, t, js, ts = _soups(name, log_n, budget)
        jg = jvox.voxelize(js, jnp.asarray(tex), j.bbox.bbox0, j.bbox.bbox1,
                           log_n=log_n, tri_budget=budget,
                           conservative=conservative)
        tg = vox.voxelize(ts, torch.from_numpy(tex), t.bbox.bbox0,
                          t.bbox.bbox1, log_n=log_n, tri_budget=budget,
                          conservative=conservative)
        _eq(tg, jg, "grid")
        occupied = tg[tg != 0]
        assert occupied.numel() > 0
        # every word has alpha 127, so bit 31 is 0 and the int32 max is
        # the uint32 max: a word above it would break the port's scatter
        assert bool(((occupied >> 24) == 127).all())
        assert bool((tg >= 0).all())


def test_grid_to_voxel_list_and_mesh_paths(monkeypatch):
    j, t = _meshes("soup")
    monkeypatch.setattr(compaction, "CHUNK_LANES", 64 * 50)
    jgrid = jvox.mesh_to_voxel_grid(j, JTexture(jnp.asarray(TEX)), log_n=5,
                                    tri_budget=64, capacity=4096)
    tgrid = vox.mesh_to_voxel_grid(t, Texture(torch.from_numpy(TEX)),
                                   log_n=5, tri_budget=64, capacity=4096)
    for field in ("centers", "colors", "count", "scale"):
        _eq(getattr(tgrid, field), getattr(jgrid, field), field)
    # a capacity below the occupied count truncates both the same way
    jg = jvox.voxelize(*(jvox.prepare_mesh(j, j.bbox, 5, 64),),
                       jnp.asarray(FLAT), j.bbox.bbox0, j.bbox.bbox1,
                       log_n=5, tri_budget=64)
    jl = jvox.grid_to_voxel_list(jg, j.bbox.bbox0, j.bbox.bbox1, log_n=5,
                                 capacity=500)
    tl = vox.grid_to_voxel_list(torch.from_numpy(np.array(jg).view(
        np.int32)), t.bbox.bbox0, t.bbox.bbox1, log_n=5, capacity=500)
    for a, b in zip(tl, jl):
        _eq(a, b)
    # the cube mesh of the grid
    tm = vox.voxel_grid_to_mesh(tgrid, cube_scale=0.9)
    jm = jvox.voxel_grid_to_mesh(jgrid, cube_scale=0.9)
    for field in ("vertices", "normals", "colors", "faces", "texcoords"):
        _eq(getattr(tm, field), getattr(jm, field), field)
    _eq(tm.bbox.bbox0, jm.bbox.bbox0)
    _eq(tm.bbox.bbox1, jm.bbox.bbox1)
    assert tm.vertices.shape[0] == 8 * int(tgrid.count)
    assert tm.faces.shape[0] == 12 * int(tgrid.count)
    empty = vox.voxel_grid_to_mesh(tgrid._replace(
        count=torch.tensor(0, dtype=torch.int32)))
    assert empty.vertices.shape == (0, 3) and empty.faces.shape == (0, 3)


def test_grid_round_trips_through_jax_types():
    """The port's grid words read as the reference's uint32 grid."""
    j, t, js, ts = _soups("quad", 5, 64)
    tg = vox.voxelize(ts, torch.from_numpy(TEX), t.bbox.bbox0, t.bbox.bbox1,
                      log_n=5, tri_budget=64)
    words = tg.numpy().view(np.uint32)
    jl = jvox.grid_to_voxel_list(jnp.asarray(words), j.bbox.bbox0,
                                 j.bbox.bbox1, log_n=5, capacity=2048)
    grid = JGrid(*jl, scale=jnp.float32(1 / 32), bbox=j.bbox)
    assert int(grid.count) == int((tg != 0).sum())
