"""Port parity for the A-buffer of map/voxelization.py, the chunked
enumeration and meshes_to_voxel_grid, against the JAX package (the shapes
and helpers of test_torch_voxelization.py).

Tolerances: every array equal word for word; enumerating in chunks equals
enumerating at once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from test_torch_voxelization import TEX, _eq, _meshes, _soup, _soups

from octree_slam_tpu.core.types import BoundingBox as JBox
from octree_slam_tpu.core.types import Mesh as JMesh
from octree_slam_tpu.core.types import Texture as JTexture
from octree_slam_tpu.map import voxelization as jvox
from octree_slam_tpu_torch.core.types import BoundingBox, Mesh, Texture
from octree_slam_tpu_torch.map import voxelization as vox
from octree_slam_tpu_torch.utils import compaction


@pytest.mark.parametrize("name", ["cube", "soup", "big"])
@pytest.mark.parametrize("conservative", [False, True],
                         ids=["thin", "conservative"])
def test_abuffer_bit_exact(name, conservative):
    j, t, js, ts = _soups(name, 5, 64)
    for capacity in (4096, 600):  # the second overflows
        ja = jvox.voxelize_abuffer(js, j.bbox.bbox0, j.bbox.bbox1, log_n=5,
                                   tri_budget=64, capacity=capacity,
                                   conservative=conservative)
        ta = vox.voxelize_abuffer(ts, t.bbox.bbox0, t.bbox.bbox1, log_n=5,
                                  tri_budget=64, capacity=capacity,
                                  conservative=conservative)
        for field, a, b in zip(ja._fields, ta, ja):
            _eq(a, b, field)
        assert bool(ta.overflowed) == (capacity == 600)


@pytest.mark.parametrize("chunk_tris", [1, 7, 64])
def test_chunked_equals_unchunked(chunk_tris, monkeypatch):
    """The port enumerates a chunk of triangles at a time; every chunking
    gives the unchunked grid and A-buffer, and the reference's."""
    j, t, js, ts = _soups("soup", 6, 256)
    kw = dict(log_n=6, tri_budget=256)
    out = {}
    for name, lanes in (("whole", 1 << 30), ("part", 256 * chunk_tris)):
        monkeypatch.setattr(compaction, "CHUNK_LANES", lanes)
        out[name] = (
            vox.voxelize(ts, torch.from_numpy(TEX), t.bbox.bbox0,
                         t.bbox.bbox1, **kw),
            vox.voxelize_abuffer(ts, t.bbox.bbox0, t.bbox.bbox1,
                                 capacity=1 << 14, **kw))
    (whole, a_whole), (part, a_part) = out["whole"], out["part"]
    assert torch.equal(whole, part)
    for a, b in zip(a_whole, a_part):
        assert torch.equal(a, b)
    ja = jvox.voxelize_abuffer(js, j.bbox.bbox0, j.bbox.bbox1,
                               capacity=1 << 14, **kw)
    _eq(a_part.frag_tri, ja.frag_tri, "frag_tri")


def test_meshes_to_voxel_grid_union():
    """Two meshes in one cubic grid over their union; the second mesh's
    texture slot is None (the flat default texel)."""
    jq, tq = _meshes("quad")
    v, f, uv = _soup(80, seed=3)
    v = v * 0.5 + np.float32(0.9)
    jb = JMesh(jnp.asarray(v), jnp.zeros(v.shape), jnp.zeros(v.shape),
               jnp.asarray(f), jnp.asarray(uv),
               JBox(jnp.asarray(v.min(0)), jnp.asarray(v.max(0))))
    tb = Mesh(torch.from_numpy(v), torch.zeros(v.shape), torch.zeros(v.shape),
              torch.from_numpy(f), torch.from_numpy(uv),
              BoundingBox(torch.from_numpy(v.min(0)),
                          torch.from_numpy(v.max(0))))
    for conservative in (False, True):
        jg = jvox.meshes_to_voxel_grid(
            [jq, jb], [JTexture(jnp.asarray(TEX)), None], log_n=5,
            tri_budget=64, capacity=4096, conservative=conservative)
        tg = vox.meshes_to_voxel_grid(
            [tq, tb], [Texture(torch.from_numpy(TEX)), None], log_n=5,
            tri_budget=64, capacity=4096, conservative=conservative)
        for field in ("centers", "colors", "count", "scale"):
            _eq(getattr(tg, field), getattr(jg, field), field)
        _eq(tg.bbox.bbox0, jg.bbox.bbox0)
        _eq(tg.bbox.bbox1, jg.bbox.bbox1)
        ext = (tg.bbox.bbox1 - tg.bbox.bbox0).numpy()
        assert np.all(ext == ext[0])  # a cube
