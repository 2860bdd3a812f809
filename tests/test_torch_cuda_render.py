"""The cone renderers (the hybrid among them) and the step's optional
features on the card against the port itself on the CPU; on the smallest
stream the hybrid's band knobs, the slab cone's word buffer, its composite
modes and its accumulate sums too; the step's hybrid frame (slab cone in
step.render, band in step.band) against hybrid.render_cone_hybrid on the
card, word for word.
Marked `cuda`: without a CUDA device every test skips. The repository's
conftest imports jax, which the card's machine lacks, so run these there
with

    python -m pytest tests/test_torch_cuda_render.py --noconftest -q

Tolerances: the two devices' transcendentals (log, exp, log2) differ in the
last ulp and their ICP sums in their order, so a leaf can move by a cell
and a ray's sample by a level at isolated pixels: at least 99% of pixels
equal as 8-bit colours or, where a colour sits on a rounding tie (x.5 of a
level, common in the march's sums), within 1e-4; map sizes within 1%. The march's exit test read
every trip, every 4 and every 9 trips gives bit-identical images on one
device. On the smallest stream (REF) both devices build one map, so there
the hybrid's mirror leaf level is equal word for word and the slab cone's
accumulate sums (integers below 2^24, exact in any order) too; its slab
words agree on 99% of cells and its composite modes within 1e-5 on 99% of
pixels."""

import dataclasses

import pytest
import torch

from octree_slam_tpu_torch import SLAMConfig, convert, pipeline
from octree_slam_tpu_torch.map import mips
from octree_slam_tpu_torch.render import conesplat, raycast
from octree_slam_tpu_torch.sensor import sources

pytestmark = pytest.mark.cuda

CFG = SLAMConfig(width=160, height=120, focal_x=133.0, focal_y=133.0,
                 voxel_resolution=0.04, max_depth=7, node_capacity=1 << 17,
                 leaf_capacity=1 << 15, insert_unique_cap=1 << 14,
                 accel_level=5, max_march_iters=64)
# the smallest stream: 4 frames at 64x48, depth 6, 5 cm leaves
REF = dict(width=64, height=48, focal_x=55.0, focal_y=55.0, pyramid_depth=2,
           pyramid_iters=(6, 6), voxel_resolution=0.05, max_depth=6,
           node_capacity=1 << 14, leaf_capacity=1 << 12,
           insert_unique_cap=1 << 10, accel_level=6, max_march_iters=48)
# the hybrid's band knobs beyond the defaults (crawl 1 x 12 trips, fixed)
BAND_KNOBS = [{"cone_band_sel_decimate": True}, {"cone_band_depth_prio": 0.5},
              {"cone_band_crawl": 4, "cone_band_iters": 6},
              {"cone_band_crawl": 4}, {"cone_band_compact_after": 8},
              {"cone_band_iters": 96},
              {"cone_band_compact_after": 8, "cone_band_iters": 96}]
# the slab cone's composite modes beside the default scatter-min
SLAB_MODES = [{"accumulate": True}, {"blend": 0.25}, {"bilinear": True}]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares the card with the CPU")
    return torch.device("cuda", 0)


def _stream(cfg, n):
    scene = sources.default_scene("cpu")
    gts = [sources.orbit_pose(i * 0.015, radius=2.0, device="cpu")
           for i in range(n)]
    return [sources.render_frame(scene, g, cfg.focal_x, cfg.focal_y,
                                 width=cfg.width, height=cfg.height)
            for g in gts], gts


def _run(cfg, frames, gts, renders, dev):
    state = pipeline.init_state(cfg, initial_pose=gts[0], device=dev)
    for f, render in zip(frames, renders):
        f = type(f)(*(x.to(dev) for x in f))
        state, out = pipeline.step(state, f, cfg, render=render)
    return state, out


@pytest.mark.parametrize("change,renders", [
    ({}, ["splat", "splat", "cone"]),
    ({}, ["splat", "cone_march", "cone_march"]),
    ({"use_dense_mips": False}, ["cone", "splat", "cone_march"]),
    ({"lazy_interior": False}, ["none", "splat", "cone_march"]),
    # the hybrid: fresh, after a heal, after a re-stamp; eager; unfused
    ({}, ["cone_hybrid", "splat", "cone_hybrid"]),
    ({}, ["cone_march", "cone_hybrid", "cone_hybrid"]),
    ({"lazy_interior": False}, ["cone_hybrid", "cone_hybrid"]),
    ({"cone_band_fused_dist": False, "insert_unique_cap": 1 << 12},
     ["cone_hybrid", "cone_hybrid"]),
    # every optional branch of the step at once
    ({"track_keyframe": True, "keyframe_max_dist": 0.04,
      "saturation_gate": True, "insert_dircache": True, "w_rgbd": 0.1},
     ["splat", "cone_hybrid", "splat", "cone_hybrid"]),
])
def test_render_card_matches_cpu(device, change, renders):
    _card_and_cpu(dataclasses.replace(CFG, **change), renders, device)


def _card_and_cpu(cfg, renders, device,
                  across=("sat_mask", "dir_keys", "dir_nodes", "dir_pos")):
    """The stream through `renders` on the card and on the CPU, held to
    the module's bounds, the state fields `across` between the devices;
    returns both final states."""
    frames, gts = _stream(cfg, len(renders))
    gs, go = _run(cfg, frames, gts, renders, device)
    cs, co = _run(cfg, frames, gts, renders, "cpu")
    assert not bool(go.diverged) and not bool(co.diverged)
    assert float((go.pose.cpu() - co.pose).abs().max()) < 1e-4
    for name in ("map_nodes", "map_leaves"):
        a, b = int(getattr(go, name)), int(getattr(co, name))
        assert abs(a - b) <= 0.01 * b, (name, a, b)
    fb = go.framebuffer.cpu()
    assert bool(torch.isfinite(fb).all())
    same = ((torch.round(fb * 255) == torch.round(co.framebuffer * 255))
            | ((fb - co.framebuffer).abs() <= 1e-4)).all(-1)
    assert float(same.float().mean()) >= 0.99
    assert float((fb[..., :3].sum(-1) > 0).float().mean()) > 0.3
    for flag in ("interior_stale", "mirror_stale", "stamps_stale"):
        assert bool(getattr(gs, flag)) == bool(getattr(cs, flag)), flag
    if renders[-1] == "cone_march" and cfg.use_dense_mips:
        for name in ("values", "occ", "dist"):
            a, b = getattr(gs.accel, name).cpu(), getattr(cs.accel, name)
            assert float((a != b).float().mean()) <= 0.01, name
        assert int(cs.accel.occ.sum()) > 0
    if renders[-1] == "cone_hybrid":
        # a hybrid frame keeps the mirror's leaf level, occ and dist
        lo = mips.level_offset(cfg.max_depth)
        for a, b in ((gs.accel.values[lo:], cs.accel.values[lo:]),
                     (gs.accel.occ, cs.accel.occ),
                     (gs.accel.dist, cs.accel.dist)):
            assert float((a.cpu() != b).float().mean()) <= 0.01
    for name in across:
        a, b = getattr(gs, name).cpu(), getattr(cs, name)
        assert a.shape == b.shape, name
        if a.numel():
            assert float((a != b).float().mean()) <= 0.01, name
    if cfg.insert_dircache:
        # a leaf more or less on one device shifts every later registry
        # position, so each device's cached positions are held to its own
        # registry
        for st in (gs, cs):
            live = st.dir_nodes >= 0
            assert int(live.sum()) > 0
            assert torch.equal(st.dir_pos[live], st.leaves.node2pos[
                st.dir_nodes[live].long()])
    if cfg.track_keyframe:
        assert float((gs.key_pose.cpu() - cs.key_pose).abs().max()) < 1e-4
        assert not torch.equal(cs.key_pose, gts[0])     # re-anchored
    return gs, cs


@pytest.mark.parametrize("render,change", [
    ("splat", {}), ("cone", {}), ("cone_march", {}), ("cone_hybrid", {}),
    *[("cone_hybrid", knob) for knob in BAND_KNOBS]])
def test_smallest_stream_card_matches_cpu(device, render, change):
    """Three splat frames, then the last frame by `render` (the hybrid
    with each band knob): the bounds above, and where both devices build
    one map the words that depend on nothing else: the hybrid's mirror
    leaf level; the slab cone's word buffer, composite modes and
    accumulate sums."""
    cfg = dataclasses.replace(CFG, **REF, **change)
    gs, cs = _card_and_cpu(cfg, ["splat"] * 3 + [render], device)
    if render == "cone_hybrid":
        lo = mips.level_offset(cfg.max_depth)
        assert torch.equal(gs.accel.values[lo:].cpu(), cs.accel.values[lo:])
    if render != "cone":
        return
    spec = pipeline._slab_spec(cfg)

    def scatter(st, fn):
        lv = st.leaves
        live = (torch.arange(lv.keys.shape[0], device=lv.keys.device)
                < lv.count) & (lv.keys >= 0)
        return fn(lv.vals, lv.keys, live, st.pool.center, st.pool.half_size,
                  st.pose, cfg.focal_x, cfg.focal_y, spec=spec,
                  depth=cfg.max_depth).cpu()

    words = [scatter(st, conesplat.slab_scatter_min) for st in (gs, cs)]
    assert int((words[1] != conesplat.EMPTY).sum()) > 0
    assert float((words[0] != words[1]).float().mean()) <= 0.01
    sums = [scatter(st, conesplat.slab_scatter_add) for st in (gs, cs)]
    assert int((sums[1][:, 0] > 0).sum()) > 0
    assert torch.equal(*sums)
    for mode in SLAB_MODES:
        a, b = (conesplat.render_cone_splat(
            st.leaves, st.pool.center, st.pool.half_size, st.pose,
            cfg.focal_x, cfg.focal_y, spec=spec, depth=cfg.max_depth,
            **mode).cpu() for st in (gs, cs))
        assert bool(torch.isfinite(a).all()), mode
        close = (a - b).abs().amax(-1) <= 1e-5
        assert float(close.float().mean()) >= 0.99, mode


def test_smallest_stream_all_features_card_matches_cpu(device):
    """Every optional branch of the step on the smallest stream, each
    frame by the hybrid. A leaf more or less on one device shifts every
    later registry position, so there the directory's rows and positions
    are held to each device's own registry, not across the devices."""
    cfg = dataclasses.replace(CFG, **REF, track_keyframe=True,
                              keyframe_max_dist=0.04, saturation_gate=True,
                              insert_dircache=True)
    _card_and_cpu(cfg, ["cone_hybrid"] * 4, device,
                  across=("sat_mask", "dir_keys"))


def test_insert_remainder_on_the_card(device):
    """The caller's pager on the card leaves the map the step's own pager
    leaves."""
    paged = dataclasses.replace(CFG, insert_unique_cap=1 << 11)
    host = dataclasses.replace(paged, device_remainder=False)
    frames, gts = _stream(CFG, 2)
    want, _ = _run(paged, frames, gts, ["splat", "splat"], device)
    state = pipeline.init_state(host, initial_pose=gts[0], device=device)
    pages = 0
    for f in frames:
        f = type(f)(*(x.to(device) for x in f))
        state, out = pipeline.step(state, f, host)
        uo, lk = out.unique_overflow, out.last_insert_key
        while bool(uo):
            state, (uo, lk) = pipeline.insert_remainder(state, f, host, lk)
            pages += 1
    assert pages >= 2
    assert torch.equal(state.pool.child, want.pool.child)
    assert torch.equal(state.pool.value, want.pool.value)
    assert torch.equal(state.leaves.keys, want.leaves.keys)
    assert torch.equal(state.leaves.vals, want.leaves.vals)


def test_exit_check_period_bit_identical_on_the_card(device):
    frames, gts = _stream(CFG, 3)
    state, _ = _run(CFG, frames, gts, ["cone_march"] * 3, device)
    lvl = pipeline._accel_level(CFG)
    imgs, dbgs = [], []
    for every in (1, 4, 9):
        fb, dbg = raycast.cone_trace_dense(
            state.accel, state.pool.center, state.pool.half_size, state.pose,
            CFG.focal_x, CFG.focal_y, width=CFG.width, height=CFG.height,
            max_depth=CFG.max_depth, dist_level=lvl,
            max_iters=CFG.max_march_iters, debug_iters=True,
            exit_check_every=every)
        imgs.append(fb)
        dbgs.append(dbg)
    assert 0 < int(dbgs[0]["p2_trips"]) <= CFG.max_march_iters
    for fb, dbg in zip(imgs[1:], dbgs[1:]):
        assert torch.equal(fb, imgs[0])
        for name in ("p1_trips", "p2_trips", "fin"):
            assert torch.equal(dbg[name], dbgs[0][name]), name
    accel = raycast.build_accel(state.pool, level=lvl)
    ptr = [raycast.cone_trace(
        state.pool, state.pose, CFG.focal_x, CFG.focal_y, width=CFG.width,
        height=CFG.height, max_depth=CFG.max_depth,
        max_iters=CFG.max_march_iters, accel=accel, accel_level=lvl,
        exit_check_every=every) for every in (1, 4, 9)]
    assert torch.equal(ptr[1], ptr[0]) and torch.equal(ptr[2], ptr[0])


def test_clone_state_on_the_card(device):
    frames, gts = _stream(CFG, 2)
    state, _ = _run(CFG, frames, gts, ["splat", "splat"], device)
    twin = convert.clone_state(state)
    f = type(frames[1])(*(x.to(device) for x in frames[1]))
    pipeline.step(twin, f, CFG, render="cone_march")
    assert bool(state.interior_stale)
    assert int(state.accel.occ.sum()) == 0       # the original is untouched


@pytest.mark.parametrize("renders,unique_cap", [
    (["cone_hybrid"] * 3, 1 << 14),
    (["cone_hybrid", "none", "cone_hybrid"], 1 << 14),
    (["cone_hybrid"] * 2, 1 << 10),
])
def test_band_stage_bit_identical_on_the_card(device, renders, unique_cap):
    """The step's hybrid frame, its slab cone in step.render and its band
    in step.band, equals hybrid.render_cone_hybrid on the state it left,
    word for word: after lazy frames, after a "none" frame and on a frame
    whose insert pages."""
    from octree_slam_tpu_torch.render import hybrid
    cfg = dataclasses.replace(CFG, insert_unique_cap=unique_cap,
                              cone_band_cap=3600, cone_band_iters=24)
    frames, gts = _stream(cfg, len(renders))
    state, out = _run(cfg, frames, gts, renders, device)
    want = hybrid.render_cone_hybrid(
        state.leaves, state.accel, state.pool.center, state.pool.half_size,
        state.pose, cfg.focal_x, cfg.focal_y, spec=pipeline._slab_spec(cfg),
        depth=cfg.max_depth, dist_level=pipeline._accel_level(cfg),
        max_range=cfg.max_range, start_dist=cfg.start_dist,
        band_cap=cfg.cone_band_cap, band_iters=cfg.cone_band_iters,
        crawl=cfg.cone_band_crawl, fused_dist=cfg.cone_band_fused_dist,
        depth_prio=cfg.cone_band_depth_prio,
        compact_after=cfg.cone_band_compact_after,
        sel_decimate=cfg.cone_band_sel_decimate)
    assert out.framebuffer.device.type == "cuda"
    assert torch.equal(out.framebuffer, want)
    assert float(want[..., 3].max()) > 0.0
