"""Host-RAM tiering of the Morton-sharded map (parallel/tiering2d.py) on
the CPU, held to the reference's guarantees (tests/test_run2d.py
TestShardedTiering, TestTiering2DLoop): a spill -> restore round trip is
bit-exact and keeps every shard in its range, a restore never clobbers a
leaf observed again while its cell was spilled, a restore that outgrows
the registries grows the map instead of losing leaves, run_slam_2d's
spill under pool pressure loses no leaf against a run without tiering,
and inverted hysteresis is refused.

Tolerance: exact (keys and words)."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import DEVICE, port_config, random_cloud, to_t

from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu_torch.map import morton
from octree_slam_tpu_torch.map.tiering import HostArchive
from octree_slam_tpu_torch.parallel import distributed, run2d, tiering2d
from octree_slam_tpu_torch.sensor import sources

CFG = port_config(SLAMConfig(
    width=64, height=48, focal_x=60.0, focal_y=60.0, max_depth=6,
    voxel_resolution=2 * 1.28 / (1 << 6), node_capacity=1 << 16,
    leaf_capacity=1 << 12, insert_unique_cap=1 << 10, map_split_level=2,
    tier_level=2, spill_keep_radius=0.8, restore_radius=1.2))
CAM_A = np.array([-0.3, -0.3, -0.3], np.float32)
CAM_B = np.array([0.75, 0.75, 0.75], np.float32)


def _mesh():
    return distributed.make_mesh(8, axis_name="map", devices=DEVICE)


def _two_cluster_map(cfg, mesh):
    """Cluster A near the first camera, cluster B across the volume: B's
    tier cells are cold from A and A's from B."""
    rng = np.random.default_rng(7)
    a = rng.uniform(-0.4, -0.05, (1500, 3)).astype(np.float32)
    b = rng.uniform(0.55, 0.95, (1500, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (3000, 3)).astype(np.float32)
    smap = distributed.make_sharded_map(cfg, mesh)
    smap, _ = distributed.insert_sharded(
        smap, to_t(np.concatenate([a, b])), to_t(cols), cfg, mesh)
    return smap


def _in_range(smap, cfg):
    shift = 3 * (cfg.max_depth - cfg.map_split_level)
    for d, lv in enumerate(smap.leaves):
        k = lv.keys.numpy()
        pref = k[k >= 0] >> shift
        assert np.all((pref >= smap.bounds[d]) & (pref < smap.bounds[d + 1]))


def test_spill_restore_round_trip_bit_exact():
    mesh = _mesh()
    smap = _two_cluster_map(CFG, mesh)
    k0, v0 = run2d.union_leaves(smap)
    archive = HostArchive(CFG.tier_level)
    smap, n_spill = tiering2d.spill_cold_sharded(smap, CFG, mesh, archive,
                                                 camera_pos=CAM_A)
    assert n_spill > 0 and len(archive) > 0
    k1, _ = run2d.union_leaves(smap)
    assert k1.size == k0.size - n_spill and np.isin(k1, k0).all()
    _in_range(smap, CFG)
    smap, cfg2, n_rest = tiering2d.restore_due_sharded(
        smap, CFG, mesh, archive, camera_pos=CAM_B)
    assert n_rest == n_spill and len(archive) == 0 and cfg2 is CFG
    k2, v2 = run2d.union_leaves(smap)
    np.testing.assert_array_equal(k2, k0)
    np.testing.assert_array_equal(v2, v0)
    _in_range(smap, CFG)


def test_restore_never_clobbers_reobservation():
    mesh = _mesh()
    smap = _two_cluster_map(CFG, mesh)
    archive = HostArchive(CFG.tier_level)
    smap, n_spill = tiering2d.spill_cold_sharded(smap, CFG, mesh, archive,
                                                 camera_pos=CAM_A)
    assert n_spill > 0
    # observe one spilled leaf again, in white, while its cell is archived
    sk, sv = archive.cells[next(iter(archive.cells))]
    target = int(sk[0])
    p0 = smap.pools[0]
    pt = morton.decode_centers(torch.tensor([target], dtype=torch.int32),
                               p0.center, p0.half_size, CFG.max_depth)
    smap, _ = distributed.insert_sharded(smap, pt, torch.ones((1, 3)), CFG,
                                         mesh)
    ku, vu = run2d.union_leaves(smap)
    new_val = vu[np.searchsorted(ku, target)]
    smap, _, _ = tiering2d.restore_due_sharded(smap, CFG, mesh, archive,
                                               camera_pos=CAM_B)
    k2, v2 = run2d.union_leaves(smap)
    assert v2[np.searchsorted(k2, target)] == new_val
    for kk, vv in zip(sk.tolist(), sv.tolist()):
        if kk != target:
            assert v2[np.searchsorted(k2, kk)] == vv


def test_restore_grows_instead_of_losing_leaves():
    cfg = dataclasses.replace(CFG, leaf_capacity=1 << 9)
    mesh = _mesh()
    smap = _two_cluster_map(cfg, mesh)
    k0, _ = run2d.union_leaves(smap)
    archive = HostArchive(cfg.tier_level)
    smap, n_spill = tiering2d.spill_cold_sharded(smap, cfg, mesh, archive,
                                                 camera_pos=CAM_A)
    assert n_spill > 0
    # fill the warm shards so that the restore overflows a registry
    pts, cols = random_cloud(1200, 8, lo=-0.45, hi=-0.02)
    smap, _ = distributed.insert_sharded(smap, to_t(pts), to_t(cols), cfg,
                                         mesh)
    smap, cfg2, n_rest = tiering2d.restore_due_sharded(
        smap, cfg, mesh, archive, camera_pos=CAM_B)
    assert n_rest == n_spill and cfg2.leaf_capacity > cfg.leaf_capacity
    assert not any(bool(lv.overflowed) for lv in smap.leaves)
    k2, _ = run2d.union_leaves(smap)
    idx = np.searchsorted(k2, k0)
    assert np.all(idx < k2.size) and np.array_equal(k2[idx], k0)


LOOP_CFG = port_config(SLAMConfig(
    width=64, height=48, focal_x=55.0, focal_y=55.0, pyramid_depth=2,
    pyramid_iters=(2, 2), voxel_resolution=0.05, max_depth=6,
    node_capacity=1 << 14, leaf_capacity=1 << 12, insert_unique_cap=1 << 11,
    map_split_level=2, relocalize=False))


def test_spill_in_loop_loses_nothing():
    """Pool pressure at a low headroom spills cold cells in run_slam_2d;
    the final map and the archive hold exactly the keys of a run without
    tiering (tracking does not read the map)."""
    cfg = dataclasses.replace(LOOP_CFG, host_spill=True, tier_level=2,
                              spill_keep_radius=1.2, restore_radius=1.0)
    scene = sources.default_scene(DEVICE)
    gt = [sources.orbit_pose(i * 0.02, device=DEVICE) for i in range(10)]
    frames = [sources.render_frame(scene, g, cfg.focal_x, cfg.focal_y,
                                   width=cfg.width, height=cfg.height)
              for g in gt]
    mesh = distributed.make_mesh2(2, 4, devices=DEVICE)
    state, cfg2, info = run2d.run_slam_2d(frames, cfg, mesh,
                                          initial_pose=gt[0],
                                          grow_headroom=0.25)
    assert [e for e in info["events"] if e["event"] == "map_spill"], \
        info["events"]
    assert not any(bool(p.overflowed) for p in state.smap.pools)
    ref_cfg = dataclasses.replace(LOOP_CFG, node_capacity=1 << 16,
                                  leaf_capacity=1 << 13)
    ref, ref_cfg2, _ = run2d.run_slam_2d(frames, ref_cfg, mesh,
                                         initial_pose=gt[0])
    ref_keys, _ = distributed.union_leaf_snapshot(ref.smap, ref_cfg2)
    live, _ = distributed.union_leaf_snapshot(state.smap, cfg2)
    arch = info["archive"]
    arch_keys = (np.concatenate([k for k, _ in arch.cells.values()])
                 if len(arch) else np.zeros((0,), np.int32))
    np.testing.assert_array_equal(
        np.unique(np.concatenate([live, arch_keys])), np.unique(ref_keys))


def test_inverted_hysteresis_rejected():
    cfg = dataclasses.replace(LOOP_CFG, host_spill=True,
                              spill_keep_radius=1.0, restore_radius=2.0)
    with pytest.raises(ValueError, match="restore_radius"):
        run2d.run_slam_2d([], cfg, distributed.make_mesh2(
            2, 4, devices=DEVICE))
