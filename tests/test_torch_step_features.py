"""Port parity for the whole of `pipeline.step`: the hybrid render mixed
with the other renders (the heal, the leaf-mirror upkeep, the re-stamp and
the three staleness flags), the keyframe anchor, the saturation gate, the
photometric term, the host-driven pager and the directory cache, as short
streams at 64x48 / depth 6 through the JAX step and the port's.

Tolerances. Both packages start from init_state with the same pose, and
their poses then agree to a few 1e-7, so unless noted the streams hold,
after every frame: poses within 1e-4; node and leaf counts, the overflow
flags and the three staleness flags equal; at least 99% of framebuffer
pixels within 1e-4; `sat_mask` and the four `dir_*` arrays bit for bit;
and, whenever the mirror is current, its leaf level (with the distance
stamps), `occ` and `dist` word for word. The keyframe stream compares
counts within 1% and no integer structure: its anchored solve ends a few
1e-7 from the reference's, which can move a point across a cell boundary;
its anchor maps agree within 1e-5 m and 1e-6 of intensity.
The photometric normal equations agree within 1e-4 of the largest entry
of A (and of b), inlier counts equal. Port against port (cached against
uncached insert, caller's pager against the step's) is bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import (DEVICE, assert_leaf_level_equal,
                          assert_step_parity, jax_frame, orbit_frames,
                          port_config, step_both, to_t, words)

from octree_slam_tpu import pipeline as jpipeline
from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu.sensor import tracking as jtracking
from octree_slam_tpu_torch import convert, pipeline
from octree_slam_tpu_torch.map import mips, svo
from octree_slam_tpu_torch.sensor import tracking

CFG = SLAMConfig(width=64, height=48, focal_x=55.0, focal_y=55.0,
                 pyramid_depth=2, pyramid_iters=(6, 6),
                 voxel_resolution=0.05, max_depth=6, node_capacity=1 << 14,
                 leaf_capacity=1 << 12, insert_unique_cap=1 << 10,
                 max_march_iters=48)
LVL = 4   # pipeline._accel_level(CFG)


@pytest.fixture(scope="module")
def stream():
    return orbit_frames(CFG, 5)


def _init_both(cfg, stream):
    gt = stream[2]
    return (jpipeline.init_state(cfg, initial_pose=jnp.asarray(gt[0])),
            pipeline.init_state(port_config(cfg), initial_pose=to_t(gt[0]),
                                device=DEVICE))


def _port_frame(stream, i):
    return convert.frame_from_numpy(stream[0][i], stream[1][i],
                                    device=DEVICE)


def _assert_mirror_is_the_rebuilt_one(tstate, tcfg, where):
    """The reference's test_lazy_leaf_mirror_matches_rebuild: the mirror a
    hybrid frame leaves has the leaf level, occ and dist of a mirror
    rebuilt from the refreshed pool and stamped."""
    twin = convert.clone_state(tstate)
    pool, fresh = pipeline.heal_for_march(twin, tcfg)
    if tcfg.cone_band_fused_dist:
        fresh = mips.encode_free_dist(fresh, max_depth=tcfg.max_depth,
                                      dist_level=LVL)
    lo = mips.level_offset(tcfg.max_depth)
    assert torch.equal(tstate.accel.values[lo:], fresh.values[lo:]), where
    assert torch.equal(tstate.accel.occ, fresh.occ), where
    assert torch.equal(tstate.accel.dist, fresh.dist), where


# each distinct (config, render) costs one compile of the JAX step
HYBRID_STREAMS = {
    # heal after the splat frame, re-stamp after the march frame
    "mixed": ({}, ["cone_hybrid", "splat", "cone_hybrid", "cone_march",
                   "cone_hybrid"]),
    # every frame eager and paged: the stamp runs on every frame, and the
    # pages' occupancy needs the refresh_dist after them
    "eager_paged": ({"lazy_interior": False, "insert_unique_cap": 1 << 8},
                    ["cone_hybrid", "cone_hybrid"]),
    # the two-gather march, the leaf-mirror scatters on remainder pages
    "unfused_paged": ({"cone_band_fused_dist": False,
                       "insert_unique_cap": 1 << 8},
                      ["cone", "cone_hybrid", "cone_hybrid"]),
}


@pytest.mark.parametrize("name", list(HYBRID_STREAMS))
def test_hybrid_stream_parity(stream, name):
    change, renders = HYBRID_STREAMS[name]
    cfg = dataclasses.replace(CFG, **change)
    tcfg = port_config(cfg)
    jstate, tstate = _init_both(cfg, stream)
    seen = set()
    for i, render in enumerate(renders):
        was = (bool(tstate.mirror_stale), bool(tstate.stamps_stale))
        jstate, jo, tstate, to = step_both(jstate, tstate, cfg, tcfg, stream,
                                           i, render)
        where = f"{name} frame {i} ({render})"
        assert_step_parity(tstate, to, jstate, jo, where)
        assert not bool(to.unique_overflow) and not bool(to.map_overflowed)
        if not bool(tstate.mirror_stale):
            assert_leaf_level_equal(tstate.accel, jstate.accel,
                                    cfg.max_depth, where)
        if render == "cone_hybrid":
            seen.add(was)
            assert not bool(tstate.mirror_stale)
            assert not bool(tstate.stamps_stale)
            assert bool(tstate.interior_stale) == cfg.lazy_interior
            _assert_mirror_is_the_rebuilt_one(tstate, tcfg, where)
            lo = mips.level_offset(cfg.max_depth)
            stamped = int((words(tstate.accel.values)[lo:] < 256).sum())
            assert (stamped > 0) == cfg.cone_band_fused_dist, where
            assert float((to.framebuffer[..., :3].sum(-1) > 0)
                         .float().mean()) > 0.3
    if name == "mixed":
        # a hybrid frame met a stale mirror, stale stamps, and neither
        assert seen == {(False, False), (True, True), (False, True)}
    assert int(to.map_leaves) > 500


def test_keyframe_stream_with_a_forced_re_anchor(stream):
    # the orbit moves 3 cm a frame: the anchor moves on every second frame
    cfg = dataclasses.replace(CFG, track_keyframe=True,
                              keyframe_max_dist=0.04)
    tcfg = port_config(cfg)
    jstate, tstate = _init_both(cfg, stream)
    anchors = []
    for i in range(5):
        jstate, jo, tstate, to = step_both(jstate, tstate, cfg, tcfg, stream,
                                           i, "splat")
        assert_step_parity(tstate, to, jstate, jo, f"frame {i}", exact=False)
        moved = torch.equal(tstate.key_pose, tstate.pose)
        assert moved == bool(np.array_equal(np.asarray(jstate.key_pose),
                                            np.asarray(jstate.pose)))
        anchors.append(moved)
        assert torch.equal(tstate.key_T_cam, torch.eye(4)) == moved
        for tl, jl in zip(tstate.key_pyramid, jstate.key_pyramid):
            np.testing.assert_allclose(tl.vertex.numpy(),
                                       np.asarray(jl.vertex), atol=1e-5)
            np.testing.assert_allclose(tl.intensity.numpy(),
                                       np.asarray(jl.intensity), atol=1e-6)
        assert not bool(to.diverged)
    assert anchors[0] and any(anchors[1:]) and not all(anchors[1:]), anchors
    gt = stream[2]
    assert float(np.abs(to.pose.numpy()[:3, 3] - gt[4][:3, 3]).max()) < 0.02


def _nearly_saturated(jstate):
    """`jstate` as numpy with every registered leaf's alpha set to 253, in
    the pool and in the registry's mirror: one more observation saturates
    it."""
    tree = jax.tree_util.tree_map(np.array, jstate)
    n = int(tree.leaves.count)
    nodes = tree.leaves.nodes[:n]
    for arr, idx in ((tree.pool.value, nodes),
                     (tree.leaves.vals, np.arange(n))):
        arr[idx] = (arr[idx] & np.uint32(0x00FFFFFF)) | np.uint32(253 << 24)
    return tree


def test_saturation_gate_mask_through_step_and_caller_pager(stream):
    """The mask through the pre-sort probe, the transition upkeep on the
    primary insert and on the caller's remainder pages (which probe too),
    with the sign bit in use."""
    cfg = dataclasses.replace(CFG, saturation_gate=True,
                              device_remainder=False,
                              insert_unique_cap=1 << 9)
    tcfg = port_config(cfg)
    jstate, _ = _init_both(cfg, stream)
    jstate, jo = jpipeline.step(jstate, jax_frame(*stream[:2], 0), cfg)
    jlk = jo.last_insert_key
    while bool(jo.unique_overflow):
        jstate, (uo, jlk) = jpipeline.insert_remainder(
            jstate, jax_frame(*stream[:2], 0), cfg, jlk)
        jo = jo._replace(unique_overflow=uo)
    tree = _nearly_saturated(jstate)
    jstate = jax.tree_util.tree_map(jnp.asarray, tree)
    tstate = convert.state_from_numpy(tree, tcfg, device=DEVICE)
    assert tstate.sat_mask.dtype == torch.int32
    assert int((tstate.sat_mask != 0).sum()) == 0
    set_bits = []
    for i in (1, 2, 3):
        jstate, jo, tstate, to = step_both(jstate, tstate, cfg, tcfg, stream,
                                           i, "splat")
        assert_step_parity(tstate, to, jstate, jo, f"frame {i}")
        uo, lk, jlk = to.unique_overflow, to.last_insert_key, \
            jo.last_insert_key
        while bool(uo):
            jstate, (juo, jlk) = jpipeline.insert_remainder(
                jstate, jax_frame(*stream[:2], i), cfg, jlk)
            tstate, (uo, lk) = pipeline.insert_remainder(
                tstate, _port_frame(stream, i), tcfg, lk)
            assert (bool(uo), int(lk)) == (bool(juo), int(jlk))
            np.testing.assert_array_equal(words(tstate.sat_mask),
                                          np.asarray(jstate.sat_mask))
            np.testing.assert_array_equal(tstate.pool.child.numpy(),
                                          np.asarray(jstate.pool.child))
        assert int(tstate.leaves.count) == int(jstate.leaves.count)
        set_bits.append(int(np.unpackbits(
            words(tstate.sat_mask).view(np.uint8)).sum()))
        # the mask is the registry's saturated leaves, nothing else
        rebuilt = pipeline.rebuild_sat_mask(tstate, tcfg)
        assert torch.equal(rebuilt.sat_mask, tstate.sat_mask)
        np.testing.assert_array_equal(
            words(rebuilt.sat_mask),
            np.asarray(jpipeline.rebuild_sat_mask(jstate, cfg).sat_mask))
    assert set_bits[0] > 500 and set_bits[-1] >= set_bits[0], set_bits
    assert int((tstate.sat_mask < 0).sum()) > 0      # bit 31 of some word
    lv = tstate.leaves
    sat = int(((lv.keys >= 0) & ((lv.vals >> 24) & 0xFF == 255)).sum())
    assert sat == set_bits[-1]
    # a gated leaf is not blended again: the first frame's transitions
    # blended no later than that frame
    off = pipeline.rebuild_sat_mask(pipeline.init_state(
        port_config(CFG), device=DEVICE), port_config(CFG))
    assert off.sat_mask.shape == (0,)


def test_insert_remainder_equals_the_in_step_pager(stream):
    """The caller's pager (device_remainder=False + insert_remainder)
    against the step's own and against the reference's host loop, on
    frames that overflow the unique cap; and its three flag updates after
    a lazy, an eager and a hybrid step (which alone leaves the mirror and
    the stamps current, so the remainder must mark both stale)."""
    paged = dataclasses.replace(CFG, insert_unique_cap=1 << 7)
    host = dataclasses.replace(paged, device_remainder=False)
    tpaged, thost = port_config(paged), port_config(host)
    jstate, t_host = _init_both(host, stream)
    _, t_step = _init_both(paged, stream)
    for i, render in enumerate(["splat", "cone_march", "cone_hybrid"]):
        t_step, so = pipeline.step(t_step, _port_frame(stream, i), tpaged,
                                   render=render)
        jstate, jo, t_host, to = step_both(jstate, t_host, host, thost,
                                           stream, i, render)
        assert bool(to.unique_overflow) and not bool(so.unique_overflow)
        assert_step_parity(t_host, to, jstate, jo, f"frame {i} step")
        uo, lk, jlk, pages = to.unique_overflow, to.last_insert_key, \
            jo.last_insert_key, 0
        while bool(uo):
            jstate, (juo, jlk) = jpipeline.insert_remainder(
                jstate, jax_frame(*stream[:2], i), host, jlk)
            t_host, (uo, lk) = pipeline.insert_remainder(
                t_host, _port_frame(stream, i), thost, lk)
            pages += 1
            assert (bool(uo), int(lk)) == (bool(juo), int(jlk))
        assert pages >= 2
        for flag in ("interior_stale", "mirror_stale", "stamps_stale"):
            assert bool(getattr(t_host, flag)) == bool(getattr(jstate, flag))
            assert bool(getattr(t_host, flag)), flag   # a lazy remainder
        np.testing.assert_array_equal(t_host.pool.child.numpy(),
                                      np.asarray(jstate.pool.child))
        assert int(lk) == int(so.last_insert_key)
        assert torch.equal(t_host.pool.child, t_step.pool.child)
        assert int(t_host.pool.n_nodes) == int(t_step.pool.n_nodes)
        for f in ("keys", "nodes", "vals", "node2pos", "count"):
            assert torch.equal(getattr(t_host.leaves, f),
                               getattr(t_step.leaves, f)), f
        if render != "cone_march":
            assert torch.equal(t_host.pool.value, t_step.pool.value)
        else:
            # the step's eager pages re-mipmapped the interior, the lazy
            # remainder did not: equal once refreshed
            healed = svo.refresh_interior(
                convert.clone_state(t_host).pool, depth=CFG.max_depth)
            assert torch.equal(healed.value, t_step.pool.value)


def test_rgbd_normal_equations_match(stream):
    cfg = dataclasses.replace(CFG, w_rgbd=0.1)
    tcfg = port_config(cfg)
    depth, color, _ = stream
    jpyr = [jtracking.build_pyramid(jnp.asarray(depth[i]),
                                    jnp.asarray(color[i]), cfg)
            for i in (0, 2)]
    tpyr = [tracking.build_pyramid(to_t(depth[i]), to_t(color[i]), tcfg)
            for i in (0, 2)]
    for level in range(cfg.pyramid_depth):
        jA, jb, jn = jtracking.rgbd_normal_equations(
            jpyr[0][level], jpyr[1][level].vertex, jpyr[1][level].intensity,
            level, cfg)
        tA, tb, tn = tracking.rgbd_normal_equations(
            tpyr[0][level], tpyr[1][level].vertex, tpyr[1][level].intensity,
            tcfg)
        assert int(tn) == int(jn) > 100, level
        for got, want in ((tA, jA), (tb, jb)):
            want = np.asarray(want)
            assert float(np.abs(want).max()) > 0
            np.testing.assert_allclose(
                got.numpy(), want, atol=1e-4 * float(np.abs(want).max()),
                rtol=0)
    # and the term moves the solve: a step with it differs from one without
    _, t_on = _init_both(cfg, stream)
    _, t_off = _init_both(CFG, stream)
    for i in range(2):
        t_on, o_on = pipeline.step(t_on, _port_frame(stream, i), tcfg)
        t_off, o_off = pipeline.step(t_off, _port_frame(stream, i),
                                     port_config(CFG))
    assert not torch.equal(o_on.pose, o_off.pose)
    assert float((o_on.pose - o_off.pose).abs().max()) < 0.01


def _registry(state):
    """The leaf registry sorted by key: (keys, words)."""
    n = int(state.leaves.count)
    keys = state.leaves.keys[:n].numpy()
    order = np.argsort(keys, kind="stable")
    return keys[order], words(state.leaves.vals[:n])[order]


def test_dircache_stream_with_miss_overflow_and_an_eager_frame(stream):
    """insert_miss_cap=64 makes every frame drop misses, so the cached
    primary insert defers to the pager; the march frame is eager (no
    directory, positions still kept); a reset in the middle costs nothing
    but hits. Against the reference bit for bit, `child` included; against
    the port's own uncached run the same map content and poses."""
    cfg = dataclasses.replace(CFG, insert_dircache=True, insert_miss_cap=64)
    tcfg = port_config(cfg)
    renders = ["splat", "splat", "cone_march", "splat", "splat"]
    jstate, tstate = _init_both(cfg, stream)
    _, plain = _init_both(CFG, stream)
    for i, render in enumerate(renders):
        if i == 4:
            jstate = jpipeline.reset_dircache(jstate)
            tstate = pipeline.reset_dircache(tstate)
            assert int((tstate.dir_keys != 0x7FFFFFFF).sum()) == 0
            assert int((tstate.dir_nodes != -1).sum()) == 0
        jstate, jo, tstate, to = step_both(jstate, tstate, cfg, tcfg, stream,
                                           i, render)
        plain, po = pipeline.step(plain, _port_frame(stream, i),
                                  port_config(CFG), render=render)
        where = f"frame {i} ({render})"
        assert_step_parity(tstate, to, jstate, jo, where)
        np.testing.assert_array_equal(tstate.pool.child.numpy(),
                                      np.asarray(jstate.pool.child), where)
        for f in ("keys", "nodes", "node2pos"):
            np.testing.assert_array_equal(
                getattr(tstate.leaves, f).numpy(),
                np.asarray(getattr(jstate.leaves, f)), err_msg=f)
        # the directory is the primary insert's touched rows; every kept
        # position is the registry's own
        live = tstate.dir_nodes >= 0
        assert int(live.sum()) > 0
        assert torch.equal(
            tstate.dir_pos[live],
            tstate.leaves.node2pos[tstate.dir_nodes[live].long()])
        # the uncached run: the same poses and the same map content
        assert torch.equal(to.pose, po.pose), where
        assert int(to.map_nodes) == int(po.map_nodes), where
        for a, b in zip(_registry(tstate), _registry(plain)):
            np.testing.assert_array_equal(a, b, err_msg=where)
    # the deferral changed where pages split, so tiles were allocated in
    # another order than in the uncached run
    assert not torch.equal(tstate.pool.child, plain.pool.child)
    with pytest.raises(ValueError):
        svo.insert(tstate.pool, torch.zeros((4, 3)), torch.zeros((4, 3)),
                   depth=CFG.max_depth, unique_cap=cfg.insert_unique_cap,
                   update_interior=True, dir_keys=tstate.dir_keys,
                   dir_nodes=tstate.dir_nodes, dir_vals=tstate.dir_vals,
                   dir_aux=tstate.dir_pos, miss_cap=64)


def test_all_features_state_crosses_both_ways(stream):
    """convert carries the eight feature fields both ways with the
    reference's dtypes, clone_state copies them, and a carried state goes
    on in the port."""
    cfg = dataclasses.replace(CFG, track_keyframe=True, saturation_gate=True,
                              insert_dircache=True)
    tcfg = port_config(cfg)
    jstate, _ = _init_both(cfg, stream)
    for i in range(2):
        jstate, _ = jpipeline.step(jstate, jax_frame(*stream[:2], i), cfg,
                                   render="cone_hybrid")
    ref = jax.tree_util.tree_map(np.asarray, jstate)
    tstate = convert.state_from_numpy(ref, tcfg, device=DEVICE)
    back = convert.state_to_numpy(tstate)
    for name in ("key_pose", "key_T_cam", "dir_keys", "dir_nodes",
                 "dir_vals", "dir_pos", "sat_mask", "mirror_stale",
                 "stamps_stale", "interior_stale"):
        want = np.asarray(getattr(ref, name))
        assert back[name].dtype == want.dtype, name
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    assert len(back["key_pyramid"]) == len(ref.key_pyramid) > 0
    for lvl, want in zip(back["key_pyramid"], ref.key_pyramid):
        for part in ("vertex", "normal", "intensity"):
            np.testing.assert_array_equal(lvl[part], getattr(want, part))
    assert int((tstate.dir_pos >= 0).sum()) > 500
    twin = convert.clone_state(tstate)
    for name in ("dir_keys", "dir_vals", "sat_mask", "key_pose"):
        a, b = getattr(tstate, name), getattr(twin, name)
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr(), name
    assert twin.key_pyramid[0].vertex.data_ptr() \
        != tstate.key_pyramid[0].vertex.data_ptr()
    # a state of a feature that the config has off is refused
    for off in ("track_keyframe", "saturation_gate", "insert_dircache"):
        with pytest.raises(ValueError):
            convert.state_from_numpy(
                ref, dataclasses.replace(tcfg, **{off: False}),
                device=DEVICE)
    jstate, jo, tstate, to = step_both(jstate, tstate, cfg, tcfg, stream, 2,
                                       "cone_hybrid")
    assert_step_parity(tstate, to, jstate, jo, "carried", exact=False)
    assert int(to.map_leaves) > 500
