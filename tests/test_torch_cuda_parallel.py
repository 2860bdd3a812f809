"""The multi-device path on the card against itself and the CPU: the
row-sharded pyramid's kernel launches, one per slab, against the launch on
the whole frame; the Morton-sharded insert on the card against the same
insert on the CPU; and the native PNG decoder against the pure one where
the native runtime builds.
Marked `cuda`: without a CUDA device every test skips. The repository's
conftest imports jax, which the card's machine lacks, so run these there
with

    python -m pytest tests/test_torch_cuda_parallel.py --noconftest -q

Tolerances: bit for bit (pyramid levels and maps, pool and registry words,
pixels)."""

import numpy as np
import pytest
import torch

from octree_slam_tpu_torch import SLAMConfig
from octree_slam_tpu_torch.io import native, png
from octree_slam_tpu_torch.parallel import distributed, run2d
from octree_slam_tpu_torch.sensor import cuda_ops, sources, tracking

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n_px", [2, 4])
def test_slab_pyramid_launches_equal_whole_frame(device, n_px):
    cfg = SLAMConfig(width=640, height=480)
    scene = sources.default_scene(device)
    f = sources.render_frame(scene, sources.orbit_pose(0.2, device=device),
                             cfg.focal_x, cfg.focal_y, width=640, height=480)
    gen = torch.Generator(device="cuda").manual_seed(n_px)
    noise = torch.randint(-60, 60, f.depth.shape, generator=gen,
                          device=device, dtype=torch.int32)
    f = f._replace(depth=torch.clamp(f.depth + noise, min=0).contiguous())
    mesh = distributed.make_mesh2(n_px, 2, devices=device)
    sensor = distributed.row_sharded_sensor(cfg, mesh)
    cuda_ops.reset_launches()
    whole, _ = sensor(f)
    launches = dict(cuda_ops.LAUNCHES)
    ref = tracking.build_pyramid(f.depth, f.color, cfg)
    assert launches == {"bilateral7x7": n_px, "bilateral_window": 0,
                        "gated_pyramid5x5": n_px}
    for lvl, (a, b) in enumerate(zip(whole, ref)):
        for name in a._fields:
            np.testing.assert_array_equal(getattr(a, name).cpu().numpy(),
                                          getattr(b, name).cpu().numpy(),
                                          err_msg=f"L{lvl} {name}")


def test_sharded_insert_card_equals_cpu(device):
    cfg = SLAMConfig(width=64, height=48, max_depth=8, voxel_resolution=0.01,
                     node_capacity=1 << 18, leaf_capacity=1 << 16,
                     insert_unique_cap=1 << 12, map_split_level=2)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1.0, 1.0, (60000, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (60000, 3)).astype(np.float32)
    out = {}
    for dev in (device, torch.device("cpu")):
        mesh = distributed.make_mesh(8, axis_name="map", devices=dev)
        smap = distributed.make_sharded_map(cfg, mesh)
        for _ in range(2):
            smap, total = distributed.insert_sharded(
                smap, torch.from_numpy(pts).to(dev),
                torch.from_numpy(cols).to(dev), cfg, mesh)
        out[dev.type] = (smap, int(total))
    (a, ta), (b, tb) = out["cuda"], out["cpu"]
    assert ta == tb > 8 * cfg.insert_unique_cap   # the shards paged
    for pa, pb in zip(a.pools, b.pools):
        assert torch.equal(pa.child.cpu(), pb.child)
        assert torch.equal(pa.value.cpu(), pb.value)
    for x, y in zip(run2d.union_leaves(a), run2d.union_leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_native_read_png_equals_pure(tmp_path):
    if not native.available():
        # the reference's own rule (tests/test_native.py): a machine
        # without libpng takes the pure decoder, and there is nothing to
        # compare
        pytest.skip(f"the native runtime does not build: "
                    f"{native.BUILD_ERROR}")
    rng = np.random.default_rng(5)
    depth = rng.integers(0, 65535, (480, 640), dtype=np.uint16)
    rgb = rng.integers(0, 255, (480, 640, 3), dtype=np.uint8)
    for img, name in ((depth, "d.png"), (rgb, "c.png")):
        p = str(tmp_path / name)
        png.write_png(p, img)
        got = native.read_png(p)
        np.testing.assert_array_equal(got, png.read_png(p))
        np.testing.assert_array_equal(got, img)
