"""The hybrid's band as the step's own stage: on a `cone_hybrid` frame
`pipeline.step` runs the distance refresh, the stamps and the slab cone in
"step.render" and the band march and merge in the sibling stage
"step.band", and its framebuffer is render/hybrid.render_cone_hybrid's
on the state the step leaves, bit for bit: after lazy hybrid frames, after
"none" frames (the heal's mirror rebuild) and on a frame whose insert
pages. With the recorder on, "step.band" holds "band.select",
"band.march" and "band.merge" and counts the band's lanes, trips and live
lane-trips; the heal counts its mirror rebuilds, the step its distance
refreshes and stamps; splat frames keep their five stages and counters.

Tolerances: none; images are compared with torch.equal, counts exactly."""

import dataclasses

import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)

from octree_slam_tpu_torch import SLAMConfig, app, convert, pipeline
from octree_slam_tpu_torch.render import conesplat, hybrid
from octree_slam_tpu_torch.sensor import sources
from octree_slam_tpu_torch.utils import spans

# slambench's CPU cut of room2cm_hybrid (160x120, 4 cm, depth 7, its band
# at 3,600 lanes) with a short trip cap
CFG = SLAMConfig(width=160, height=120, focal_x=532.57 / 4,
                 focal_y=531.54 / 4, voxel_resolution=0.04, max_depth=7,
                 node_capacity=1 << 16, leaf_capacity=1 << 14,
                 insert_unique_cap=4096, start_dist=0.002, dist_max_skip=15,
                 cone_band_cap=3600, cone_band_iters=8,
                 cone_band_fused_dist=True)
FRAMES = 6
STAGES = ["step.pyramid", "step.track", "step.heal", "step.fuse",
          "step.render"]


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.stop()
    yield
    spans.stop()


@pytest.fixture(scope="module")
def orbit():
    scene = sources.default_scene("cpu")
    poses = [sources.orbit_pose(0.05 * i, radius=2.0, device="cpu")
             for i in range(FRAMES)]
    return [sources.render_frame(scene, p, CFG.focal_x, CFG.focal_y,
                                 width=CFG.width, height=CFG.height)
            for p in poses], poses


def composed_view(state, cfg):
    """hybrid.render_cone_hybrid on the map, mirror and pose a step left."""
    return hybrid.render_cone_hybrid(
        state.leaves, state.accel, state.pool.center, state.pool.half_size,
        state.pose, cfg.focal_x, cfg.focal_y,
        spec=pipeline._slab_spec(cfg), depth=cfg.max_depth,
        dist_level=pipeline._accel_level(cfg), max_range=cfg.max_range,
        start_dist=cfg.start_dist, band_cap=cfg.cone_band_cap,
        band_iters=cfg.cone_band_iters, crawl=cfg.cone_band_crawl,
        fused_dist=cfg.cone_band_fused_dist,
        depth_prio=cfg.cone_band_depth_prio,
        compact_after=cfg.cone_band_compact_after,
        sel_decimate=cfg.cone_band_sel_decimate)


def judged_step(frames, poses, cfg, renders):
    """Step the frames with `renders`, the last one a hybrid frame under
    the recorder. Returns (its framebuffer, the composed view of the state
    it left, its counters)."""
    state = pipeline.init_state(cfg, initial_pose=poses[0], device="cpu")
    for f, render in zip(frames[:len(renders) - 1], renders):
        state, _ = pipeline.step(state, f, cfg, render=render)
    spans.start()
    with spans.frame(0):
        state, out = pipeline.step(state, frames[len(renders) - 1], cfg,
                                   render=renders[-1])
    rec = spans.stop()
    return out.framebuffer, composed_view(state, cfg), rec.counters[0]


@pytest.mark.parametrize("case,renders,unique_cap", [
    ("lazy", ["cone_hybrid"] * 4, 1 << 15),
    ("after_none", ["cone_hybrid", "none", "none", "cone_hybrid"], 1 << 15),
    ("paged", ["cone_hybrid"] * 3, 512),
])
def test_band_stage_equals_render_cone_hybrid(orbit, case, renders,
                                              unique_cap):
    frames, poses = orbit
    cfg = dataclasses.replace(CFG, insert_unique_cap=unique_cap)
    fb, want, counters = judged_step(frames, poses, cfg, renders)
    assert torch.equal(fb, want)
    assert float(fb[..., 3].max()) > 0.0
    assert counters.get("mirror_rebuilds", 0) == (case == "after_none")
    assert (counters["insert_passes"] >= 2) == (case == "paged")
    assert counters["band_lanes"] == cfg.cone_band_cap
    assert counters["band_trips"] == cfg.cone_band_iters


def test_band_spans_and_counters(orbit):
    """run_slam at render_every 2: the hybrid frames carry step.band after
    step.render with the band's three spans inside, and its counters; the
    hybrid frame after a "none" frame rebuilds the mirror once; "none"
    frames carry neither."""
    frames, poses = orbit

    spans.start()
    app.run_slam(lambda i: frames[i], FRAMES, CFG, initial_pose=poses[0],
                 device="cpu", render_every=2, render_mode="cone_hybrid")
    rec = spans.stop()
    assert rec.frames == list(range(FRAMES))
    lanes = min(CFG.cone_band_cap, CFG.width * CFG.height)
    for i in rec.frames:
        own = [s for s in rec.frame_spans(i) if s.name.startswith("step.")
               and rec.spans[s.parent].name == "app.frame"]
        names = [s.name for s in own]
        c = rec.counters[i]
        if i % 2:
            assert names == STAGES
            assert not any(s.name.startswith("band.")
                           for s in rec.frame_spans(i))
            assert "band_lanes" not in c and "mirror_rebuilds" not in c
            continue
        assert names == STAGES + ["step.band"]
        render, band = own[-2], own[-1]
        assert render.name == "step.render" and render.t1 <= band.t0
        inner = [s for s in rec.frame_spans(i)
                 if s.parent == rec.spans.index(band)]
        assert [s.name for s in inner] == ["band.select", "band.march",
                                           "band.merge"]
        assert c["band_lanes"] == lanes
        assert c["band_trips"] == CFG.cone_band_iters
        assert 0 < c["band_live_lane_trips"] <= lanes * CFG.cone_band_iters
        # frame 0 starts from a current (empty) mirror; every later hybrid
        # frame follows a "none" frame
        assert c.get("mirror_rebuilds", 0) == (i > 0)
        # a lazy hybrid frame refreshes and stamps once where it created
        # leaves or healed: every frame of this orbit
        assert c["dist_refreshes"] == c["dist_stamps"] == 1


@pytest.mark.parametrize("compact_after", [999, 4])
def test_live_lane_trips_counts_the_live_lanes(orbit, compact_after):
    """band_live_lane_trips over K trips is the sum, over k < K, of the
    lanes still active after k trips (the capped lanes of a k-trip march);
    band_trips is the compacting march's device count where it compacts.
    Off, the band adds no operation for the counter; on, the fixed-trip
    march adds two a trip."""
    frames, poses = orbit
    state = pipeline.init_state(CFG, initial_pose=poses[0], device="cpu")
    for f in frames[:3]:
        state, _ = pipeline.step(state, f, CFG, render="cone_hybrid")
    spec = pipeline._slab_spec(CFG)
    fb, _, z_first = conesplat.render_cone_splat(
        state.leaves, state.pool.center, state.pool.half_size, state.pose,
        CFG.focal_x, CFG.focal_y, spec=spec, depth=CFG.max_depth,
        want_aux=True)
    K = 8

    def band(iters, debug=False):
        return hybrid.band_march_merge(
            fb, z_first, state.accel, state.pool.center,
            state.pool.half_size, state.pose, CFG.focal_x, CFG.focal_y,
            spec=spec, depth=CFG.max_depth,
            dist_level=pipeline._accel_level(CFG), band_cap=CFG.cone_band_cap,
            band_iters=iters, compact_after=compact_after, fused_dist=True,
            debug_band=debug)

    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    live = sum(int(band(k, debug=True)[1]["capped"].sum()) for k in range(K))
    with Ops() as off:
        img_off = band(K)
    spans.start()
    with spans.frame(0):
        with Ops() as on:
            img = band(K)
        _, dbg = band(K, debug=True)
    c = spans.stop().counters[0]
    assert c["band_live_lane_trips"] == 2 * live > 0
    assert c["band_trips"] == 2 * dbg["trips"]
    assert torch.equal(img, img_off)
    if compact_after == 999:
        assert on.n - off.n == 2 * K


def test_splat_frames_keep_their_stages(orbit):
    """A splat frame under the recorder: the five step stages, no band
    span, and only the insert's, ICP's and the splat path's counters."""
    frames, poses = orbit
    state = pipeline.init_state(CFG, initial_pose=poses[0], device="cpu")
    state, _ = pipeline.step(state, frames[0], CFG, render="cone_hybrid")
    spans.start()
    with spans.frame(0):
        pipeline.step(convert.clone_state(state), frames[1], CFG,
                      render="splat")
    rec = spans.stop()
    assert [s.name for s in rec.spans if s.name.startswith("step.")] == STAGES
    assert not any(s.name.startswith("band.") for s in rec.spans)
    assert set(rec.counters[0]) == {"insert_passes", "unique_leaves",
                                    "new_leaves", "track_eager",
                                    "splat_eager"}
