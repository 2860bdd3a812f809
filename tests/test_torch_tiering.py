"""Port parity for host tiering (map/tiering.py): spill_cold and
restore_due against the JAX package cell by cell from one shared state,
the bit-exact spill -> restore round trip, restores that keep leaves the
camera observed again while their region was spilled, a restore that has
to grow and loses nothing, the no-op spill, the inverted hysteresis, and
run_slam spilling under pressure on the same frames as the JAX package.

Tolerance: bit-exact (every archived cell's keys and words, pools,
registries, mirrors, flags, capacities, leaf counts, the frames where a
spill or a restore fired); poses within 1e-4."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import (DEVICE, assert_state_equal, jax_frame, np_state,
                          orbit_frames, orbit_port_frames, port_config,
                          words)

from octree_slam_tpu import app as japp
from octree_slam_tpu import pipeline as jpipeline
from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu.map import tiering as jtiering
from octree_slam_tpu_torch import app, convert
from octree_slam_tpu_torch.map import morton, svo, tiering
from octree_slam_tpu_torch.render.splat import append_new_leaves

CFG = SLAMConfig(width=80, height=60, focal_x=70.0, focal_y=70.0,
                 pyramid_depth=2, pyramid_iters=(6, 6),
                 voxel_resolution=0.04, max_depth=8,
                 node_capacity=1 << 17, leaf_capacity=1 << 15,
                 extract_capacity=1 << 15, insert_unique_cap=1 << 13,
                 max_march_iters=48, host_spill=True,
                 spill_keep_radius=1.0, restore_radius=0.9,
                 precompile_ahead=False)
TCFG = port_config(CFG)


@pytest.fixture(scope="module")
def built():
    """The JAX state after three splat frames of the orbit, and the port's
    copy of it (numpy)."""
    depth, color, gt = orbit_frames(CFG, 3)
    jstate = jpipeline.init_state(CFG, initial_pose=jnp.asarray(gt[0]))
    for i in range(3):
        jstate, _ = jpipeline.step(jstate, jax_frame(depth, color, i), CFG)
    return np_state(jstate)


def _both(built):
    jstate = jax_tree(built)
    tstate = convert.state_from_numpy(built, TCFG, device=DEVICE)
    return jstate, tstate


def jax_tree(np_tree):
    import jax
    return jax.tree_util.tree_map(jnp.asarray, np_tree)


def _leaf_words(state, cfg):
    """{key: u32 word} of every occupied leaf of a port state."""
    _, keys, vals = tiering._leaf_snapshot(state, cfg)
    return dict(zip(keys.tolist(), vals.tolist()))


def _assert_archives_equal(ta, ja):
    assert sorted(ta.cells) == sorted(ja.cells)
    for p in ja.cells:
        (tk, tv), (jk, jv) = ta.cells[p], ja.cells[p]
        assert tv.dtype == np.uint32
        np.testing.assert_array_equal(tk, np.asarray(jk), err_msg=str(p))
        np.testing.assert_array_equal(tv, np.asarray(jv), err_msg=str(p))


def test_spill_and_restore_match_reference(built):
    jstate, tstate = _both(built)
    cam = np.asarray(built.pose)[:3, 3]
    ja = jtiering.HostArchive(CFG.tier_level)
    ta = tiering.HostArchive(TCFG.tier_level)
    jstate, jcfg, jn = jtiering.spill_cold(jstate, CFG, ja, camera_pos=cam)
    tstate, tcfg, tn = tiering.spill_cold(tstate, TCFG, ta, camera_pos=cam)
    assert tn == jn > 0 and len(ta) == len(ja) > 0
    assert tcfg.leaf_capacity == jcfg.leaf_capacity
    _assert_archives_equal(ta, ja)
    assert_state_equal(tstate, jstate, "after spill")

    jbig = dataclasses.replace(jcfg, restore_radius=1e9)
    tbig = dataclasses.replace(tcfg, restore_radius=1e9)
    jstate, jbig, jr = jtiering.restore_due(jstate, jbig, ja, camera_pos=cam)
    tstate, tbig, tr = tiering.restore_due(tstate, tbig, ta, camera_pos=cam)
    assert tr == jr == tn and len(ta) == len(ja) == 0
    assert_state_equal(tstate, jstate, "after restore")
    assert bool(tstate.interior_stale) and bool(tstate.mirror_stale)


def test_round_trip_is_bit_exact(built):
    """spill -> restore gives back every leaf word, and refresh_interior of
    the restored pool every interior word of every leaf's ancestors, as
    seen through the dense mirror (keyed by cell, not node index)."""
    from octree_slam_tpu_torch.map import mips
    _, tstate = _both(built)
    cfg = TCFG
    before = _leaf_words(tstate, cfg)
    pool0 = svo.refresh_interior(convert.clone_state(tstate).pool,
                                 depth=cfg.max_depth)
    mirror0 = mips.rebuild_from_pool(pool0, max_depth=cfg.max_depth,
                                     dist_level=3)
    n0 = int(tstate.pool.n_nodes)
    cam = tstate.pose[:3, 3]
    archive = tiering.HostArchive(cfg.tier_level)
    tstate, cfg, n_spilled = tiering.spill_cold(tstate, cfg, archive,
                                                camera_pos=cam)
    assert n_spilled > 0 and archive.n_leaves == n_spilled
    assert int(tstate.pool.n_nodes) < n0
    kept = _leaf_words(tstate, cfg)
    spilled = {}
    for k, v in archive.cells.values():
        spilled.update(zip(k.tolist(), v.tolist()))
    assert set(kept) | set(spilled) == set(before)
    assert not set(kept) & set(spilled)
    assert int(tstate.leaves.count) == len(kept)

    big = dataclasses.replace(cfg, restore_radius=1e9)
    tstate, big, n = tiering.restore_due(tstate, big, archive, camera_pos=cam)
    assert n == n_spilled and len(archive) == 0
    assert _leaf_words(tstate, big) == before
    assert int(tstate.leaves.count) == len(before)
    pool1 = svo.refresh_interior(tstate.pool, depth=cfg.max_depth)
    mirror1 = mips.rebuild_from_pool(pool1, max_depth=cfg.max_depth,
                                     dist_level=3)
    assert torch.equal(mirror0.values, mirror1.values)


def test_spill_noop_keeps_stale_flag(built):
    _, tstate = _both(built)
    cfg = dataclasses.replace(TCFG, spill_keep_radius=1e9)
    archive = tiering.HostArchive(cfg.tier_level)
    n0 = int(tstate.pool.n_nodes)
    stale0 = bool(tstate.interior_stale)
    assert stale0
    tstate, cfg, n = tiering.spill_cold(tstate, cfg, archive,
                                        camera_pos=np.zeros(3))
    assert n == 0 and len(archive) == 0
    assert int(tstate.pool.n_nodes) == n0
    # only the pool's interiors were refreshed, not the dense mirror
    assert bool(tstate.interior_stale) == stale0


def _observe(state, cfg, keys, rgb):
    """Insert one point at each key's leaf centre with colour `rgb`."""
    c = morton.decode_centers(torch.as_tensor(keys, dtype=torch.int32),
                              state.pool.center, state.pool.half_size,
                              cfg.max_depth)
    pool, st = svo.insert(state.pool, c,
                          torch.tensor([rgb] * len(keys)),
                          depth=cfg.max_depth,
                          unique_cap=cfg.insert_unique_cap,
                          update_interior=False)
    return state._replace(pool=pool, leaves=append_new_leaves(state.leaves,
                                                              st),
                          interior_stale=torch.tensor(True)), c


def test_restore_keeps_reobserved_leaves(built):
    _, tstate = _both(built)
    cfg = TCFG
    cam = tstate.pose[:3, 3]
    archive = tiering.HostArchive(cfg.tier_level)
    tstate, cfg, n_spilled = tiering.spill_cold(tstate, cfg, archive,
                                                camera_pos=cam)
    assert n_spilled > 0
    k0, v0 = next(iter(archive.cells.values()))
    tstate, c = _observe(tstate, cfg, [int(k0[0])], [1.0, 0.0, 0.0])
    live = int(svo.query_points(tstate.pool, c, depth=cfg.max_depth)[0][0])
    big = dataclasses.replace(cfg, restore_radius=1e9)
    tstate, big, n = tiering.restore_due(tstate, big, archive, camera_pos=cam)
    assert n == n_spilled
    after = int(svo.query_points(tstate.pool, c, depth=big.max_depth)[0][0])
    archived = int(v0[:1].view(np.int32)[0])
    assert after == live and (after != archived or live == archived)


def test_restore_grows_and_loses_nothing(built):
    """A restore into a pool filled close to its capacity by new geometry
    must grow and retry: every spilled leaf comes back, with its archived
    word where the filler did not observe it again."""
    _, tstate = _both(built)
    cfg = TCFG
    cam = tstate.pose[:3, 3]
    before = _leaf_words(tstate, cfg)
    archive = tiering.HostArchive(cfg.tier_level)
    tstate, cfg, n_spilled = tiering.spill_cold(tstate, cfg, archive,
                                                camera_pos=cam)
    assert n_spilled > 0
    rng = np.random.default_rng(3)
    touched = set()
    for _ in range(64):
        if int(tstate.pool.n_nodes) >= cfg.node_capacity * 7 // 8:
            break
        pts = torch.from_numpy(rng.uniform(-4.5, 4.5, (4096, 3)).astype(
            np.float32))
        cols = torch.from_numpy(rng.uniform(0, 1, (4096, 3)).astype(
            np.float32))
        fk, fok = morton.encode(pts, tstate.pool.center,
                                tstate.pool.half_size, cfg.max_depth)
        touched.update(fk[fok].tolist())
        pool, st = svo.insert(tstate.pool, pts, cols, depth=cfg.max_depth,
                              unique_cap=cfg.insert_unique_cap)
        tstate = tstate._replace(pool=pool,
                                 leaves=append_new_leaves(tstate.leaves, st),
                                 interior_stale=torch.tensor(True))
    assert int(tstate.pool.n_nodes) >= cfg.node_capacity * 7 // 8
    spilled = {int(k) for ks, _ in archive.cells.values() for k in ks}
    big = dataclasses.replace(cfg, restore_radius=1e9)
    tstate, big, n = tiering.restore_due(tstate, big, archive, camera_pos=cam)
    assert n == len(spilled)
    assert big.node_capacity > cfg.node_capacity
    after = _leaf_words(tstate, big)
    untouched = spilled - touched
    assert len(untouched) > 100
    for k in spilled:
        assert k in after
        if k in untouched:
            assert after[k] == before[k]


def test_inverted_hysteresis_rejected():
    cfg = port_config(SLAMConfig(width=32, height=24, max_depth=5,
                                 node_capacity=1 << 12, leaf_capacity=1 << 10,
                                 host_spill=True, spill_keep_radius=2.2))
    assert cfg.restore_radius >= cfg.spill_keep_radius
    with pytest.raises(ValueError, match="hysteresis|restore_radius"):
        app.run_slam(lambda i: None, 0, cfg, device=DEVICE)


def test_run_slam_spills_like_reference(capsys):
    """A pool too small for the scene with host_spill on: the port's
    run_slam spills, restores and grows on the same frames as the JAX
    package's, with the same capacities and leaf counts."""
    cfg = dataclasses.replace(
        CFG, node_capacity=1 << 13, leaf_capacity=1 << 12,
        extract_capacity=1 << 12, spill_keep_radius=1.6, restore_radius=1.2)
    stream = orbit_frames(cfg, 8, step_angle=0.02)
    depth, color, gt = stream
    frames = orbit_port_frames(stream)

    def events():
        import json
        out = []
        for line in capsys.readouterr().out.splitlines():
            if line.startswith("{") and '"event"' in line:
                rec = json.loads(line)
                out.append((rec["frame"], rec["event"],
                             rec.get("leaves"), rec.get("node_capacity"),
                             rec.get("leaf_capacity")))
        return out

    jsink, tsink = [], []
    jres = japp.run_slam(lambda i: jax_frame(depth, color, i), len(gt), cfg,
                         initial_pose=gt[0], gt_fn=lambda i: gt[i],
                         render_every=0, state_out=jsink)
    jev = events()
    tres = app.run_slam(lambda i: frames[i], len(gt), port_config(cfg),
                        initial_pose=gt[0], gt_fn=lambda i: gt[i],
                        render_every=0, state_out=tsink, device=DEVICE)
    tev = events()
    assert not tres.diverged and not jres.diverged
    assert tres.spilled_leaves == jres.spilled_leaves > 0
    assert tres.restored_leaves == jres.restored_leaves
    assert tres.archived_cells == jres.archived_cells
    assert tev == jev and any(e[1] == "map_spill" for e in tev)
    np.testing.assert_allclose(np.stack(tres.poses), np.stack(jres.poses),
                               atol=1e-4)
    assert (tres.final_cfg.node_capacity, tres.final_cfg.leaf_capacity) == \
        (jres.final_cfg.node_capacity, jres.final_cfg.leaf_capacity)
    _assert_archives_equal(tres.archive, jres.archive)
    np.testing.assert_array_equal(words(tsink[0].pool.value),
                                  np.asarray(jsink[0].pool.value))
