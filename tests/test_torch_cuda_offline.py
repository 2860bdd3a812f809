"""The offline paths on the card against the port itself on the CPU: the
dense voxel grid (THIN and CONSERVATIVE, textured) and the A-buffer of a
seeded triangle soup, the triangle rasterizer on a voxel-cube mesh whose
faces tie in depth, and the packed point and voxel-splat z-buffers.
Marked `cuda`: without a CUDA device every test skips. The repository's
conftest imports jax, which the card's machine lacks, so run these there
with

    python -m pytest tests/test_torch_cuda_offline.py --noconftest -q

Tolerances: grids, A-buffers and z-buffer words equal word for word; the
rasterized coverage equal on every pixel (the multiply-adds that decide it
are float64 on both devices) and colours within 1e-5, the parity tests'
bound: the shading is plain float32, and its normalisations (a reduction
each) and the Phong power of 32 round differently on the two devices (the
card's largest difference read 1.7e-6)."""

import numpy as np
import pytest
import torch

from octree_slam_tpu_torch.core.types import BoundingBox, Mesh, VoxelGrid
from octree_slam_tpu_torch.core import camera
from octree_slam_tpu_torch.map import voxelization as vox
from octree_slam_tpu_torch.render import points, raster
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
