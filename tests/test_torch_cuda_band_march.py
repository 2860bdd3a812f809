"""The hybrid band's CUDA kernel (render/band_ops.py, csrc/band_march.cu)
against its plain version, the eager loop of render/hybrid.py, on the card,
at room2cm_hybrid's production shape: a 640x480 frame, 2 cm leaves at
depth 9, the band 57,600 lanes x 24 trips, on a map built along the orbit,
with fused_dist true and false. The band's lanes as the step marks them,
plus crafted lanes that miss the box, leave the range part way through a
surface or move along one axis only; the step's hybrid framebuffer against
render_cone_hybrid with the plain march.
Marked `cuda`: without a CUDA device every test skips. The repository's
conftest imports jax, which the card's machine lacks, so run these there
with

    python -m pytest tests/test_torch_cuda_band_march.py --noconftest -q

Tolerances: none. The kernel repeats the eager loop's float32 arithmetic
op for op, so rgb, w and active are equal word for word (torch.equal) and
the live lane-trips exactly."""

import dataclasses

import pytest
import torch

from octree_slam_tpu_torch import SLAMConfig, pipeline
from octree_slam_tpu_torch.render import band_ops, conesplat, hybrid
from octree_slam_tpu_torch.sensor import sources
from octree_slam_tpu_torch.utils import spans

pytestmark = pytest.mark.cuda

# slambench's room2cm_hybrid: 640x480, 2 cm leaves, depth 9, pools 2^20 /
# 2^17, the band 57,600 lanes x 24 trips
CFG = SLAMConfig(voxel_resolution=0.02, max_depth=9, node_capacity=1 << 20,
                 leaf_capacity=1 << 17, insert_unique_cap=65_536,
                 cone_band_cap=57_600, cone_band_iters=24)
FRAMES = 4
STEP = 0.0136               # rad a frame: the benchmark orbit's 0.78 deg
SEED_HALO = 4               # band_march_merge's default


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the band kernel runs only there")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module", params=[True, False],
                ids=["fused_dist", "dist_gather"])
def mapped(request, card):
    """(cfg, state, the last step's output, band launches) after FRAMES
    hybrid frames along the orbit."""
    cfg = dataclasses.replace(CFG, cone_band_fused_dist=request.param)
    scene = sources.default_scene(card)
    poses = [sources.orbit_pose(i * STEP, radius=2.0, device=card)
             for i in range(FRAMES)]
    state = pipeline.init_state(cfg, initial_pose=poses[0], device=card)
    before = band_ops.LAUNCHES["band_march"]
    for pose in poses:
        frame = sources.render_frame(scene, pose, cfg.focal_x, cfg.focal_y,
                                     width=cfg.width, height=cfg.height)
        state, out = pipeline.step(state, frame, cfg, render="cone_hybrid")
    torch.cuda.synchronize()
    return cfg, state, out, band_ops.LAUNCHES["band_march"] - before


def _band(cfg, state):
    """The band's inputs as band_march_merge makes them: (sel, z_first,
    spec, C, C2)."""
    spec = pipeline._slab_spec(cfg)
    fb, _, z_first = conesplat.render_cone_splat(
        state.leaves, state.pool.center, state.pool.half_size, state.pose,
        cfg.focal_x, cfg.focal_y, spec=spec, depth=cfg.max_depth,
        want_aux=True)
    C = cfg.cone_band_cap
    sel = hybrid._select(fb, z_first, spec, C, 2, 0.0, False)
    return sel, z_first, spec, C, max(128, C // 4)


def _recorded(fn):
    """fn() under the span recorder: (its result, the frame's counters)."""
    spans.start()
    with spans.frame(0):
        out = fn()
    return out, spans.stop().counters[0]


def _plain(monkeypatch):
    monkeypatch.setattr(hybrid, "_band_kernel", lambda *a: False)


def test_march_equals_the_eager_loop(mapped, monkeypatch):
    """hybrid._march on the step's band: the kernel's lanes equal the
    eager loop's word for word, and so do the live lane-trips."""
    cfg, state, _, _ = mapped
    sel, z_first, spec, C, C2 = _band(cfg, state)

    def march():
        return hybrid._march(
            sel, z_first, state.accel, state.pool.center,
            state.pool.half_size, state.pose, cfg.focal_x, cfg.focal_y,
            spec=spec, depth=cfg.max_depth,
            dist_level=pipeline._accel_level(cfg), max_range=cfg.max_range,
            start_dist=cfg.start_dist, band_iters=cfg.cone_band_iters,
            compact_after=cfg.cone_band_compact_after, seed_halo=SEED_HALO,
            crawl=1, fused_dist=cfg.cone_band_fused_dist, C=C, C2=C2)

    before = band_ops.LAUNCHES["band_march"]
    got, c_got = _recorded(march)
    assert band_ops.LAUNCHES["band_march"] == before + 1
    _plain(monkeypatch)
    want, c_want = _recorded(march)
    assert band_ops.LAUNCHES["band_march"] == before + 1
    for g, w in zip(got[:3], want[:3]):
        assert g.device.type == "cuda"
        assert torch.equal(g, w)
    assert c_got["band_kernel"] == 1 and "band_eager" not in c_got
    assert c_want["band_eager"] == 1 and "band_kernel" not in c_want
    assert c_got["band_live_lane_trips"] == c_want["band_live_lane_trips"]
    assert c_got["band_trips"] == c_want["band_trips"] == cfg.cone_band_iters
    rgb, w, active = want[:3]
    # the production band: lanes that saturated, lanes still active at the
    # cap, and every lane's live trips between 1 and the cap
    assert bool((~active & (w == 255.0)).any()) and bool(active.any())
    assert C <= c_want["band_live_lane_trips"] <= C * cfg.cone_band_iters


def _crafted(origin, dirs, inv_dirs, limit, start, miss):
    """The band's lanes plus crafted ones: 256 copies that miss the box,
    1,024 whose range ends 0 to 0.3 m past their start (most leave it,
    some part way through a surface) and the six axis rays and two rays
    whose other components are below the march's 1e-9 (moves is false
    there)."""
    dev = dirs.device
    n = dirs.shape[0]
    pick = torch.arange(0, n, max(1, n // 1024), device=dev)[:1024]
    axes = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                         [0, 0, 1], [0, 0, -1], [1, 1e-10, 0],
                         [-1e-10, 0, -1]], dtype=torch.float32, device=dev)
    axes = axes / torch.linalg.norm(axes, dim=-1, keepdim=True)
    d = torch.cat([dirs, dirs[pick[:256]], dirs[pick], axes])
    inv = torch.where(d.abs() > 1e-9, 1.0 / d, torch.inf)
    reach = torch.linspace(0.0, 0.3, pick.numel(), device=dev)
    lim = torch.cat([limit, limit[pick[:256]], start[pick] + reach,
                     torch.full((8,), 5.0, device=dev)])
    st = torch.cat([start, start[pick[:256]], start[pick],
                    torch.full((8,), 0.002, device=dev)])
    ms = torch.cat([miss, torch.ones(256, dtype=torch.bool, device=dev),
                    miss[pick], torch.zeros(8, dtype=torch.bool,
                                            device=dev)])
    return origin, d, inv, lim, st, ms, (n, n + 256, n + 256 + pick.numel())


def test_crafted_lanes(mapped):
    """band_ops.band_march against hybrid._trips_eager on the band's lanes
    plus crafted ones, with the live lane-trips counted: equal word for
    word. The crafted lanes do what they were made for: missed lanes
    finish at once with w 255 and no colour, and lanes whose range ends
    leave it."""
    cfg, state, _, _ = mapped
    sel, z_first, spec, C, C2 = _band(cfg, state)
    half = torch.as_tensor(state.pool.half_size, dtype=torch.float32)
    origin, dirs, inv, lim, st, ms, (a, b, c) = _crafted(*hybrid._rays(
        sel, z_first, state.pool.center, half, state.pose, cfg.focal_x,
        cfg.focal_y, spec=spec, depth=cfg.max_depth,
        max_range=cfg.max_range, start_dist=cfg.start_dist,
        seed_halo=SEED_HALO))
    n = dirs.shape[0]
    kw = dict(depth=cfg.max_depth, dist_level=pipeline._accel_level(cfg),
              max_range=cfg.max_range, band_iters=cfg.cone_band_iters,
              fused_dist=cfg.cone_band_fused_dist)
    got = band_ops.band_march(origin, dirs, inv, lim, st, ms, state.accel,
                              state.pool.center, half, count_live=True, **kw)
    want = hybrid._trips_eager(origin, dirs, inv, lim, st, ms, state.accel,
                               state.pool.center, half,
                               compact_after=cfg.cone_band_compact_after,
                               crawl=1, C2=max(128, n // 4),
                               count_live=True, **kw)
    rgb, w, active = want[:3]
    for g, x in zip(got[:3], (rgb, w, active)):
        assert torch.equal(g, x)
    assert int(got[3]) == int(want[5]) > 0
    assert bool((w[a:b] == 255.0).all()) and not bool(rgb[a:b].any())
    assert not bool(active[a:b].any())
    assert not bool(active[b:c].any())
    assert bool((w[b:c] == 255.0).all())
    # rays that left the range with some colour were rescaled by 127 / w
    assert bool((rgb[b:c].sum(dim=-1) > 0.0).any())


@pytest.mark.parametrize("iters", [0, 1, 7])
def test_short_trip_caps(mapped, iters):
    """0, 1 and 7 trips: the lanes as they start, after one sample and part
    way, equal on both paths."""
    cfg, state, _, _ = mapped
    sel, z_first, spec, C, C2 = _band(cfg, state)
    half = torch.as_tensor(state.pool.half_size, dtype=torch.float32)
    lanes = hybrid._rays(
        sel, z_first, state.pool.center, half, state.pose, cfg.focal_x,
        cfg.focal_y, spec=spec, depth=cfg.max_depth,
        max_range=cfg.max_range, start_dist=cfg.start_dist,
        seed_halo=SEED_HALO)
    kw = dict(depth=cfg.max_depth, dist_level=pipeline._accel_level(cfg),
              max_range=cfg.max_range, band_iters=iters,
              fused_dist=cfg.cone_band_fused_dist)
    got = band_ops.band_march(*lanes, state.accel, state.pool.center, half,
                              **kw)
    want = hybrid._trips_eager(*lanes, state.accel, state.pool.center, half,
                               compact_after=999, crawl=1, C2=C2,
                               count_live=False, **kw)
    assert got[3] is None
    for g, x in zip(got[:3], want[:3]):
        assert torch.equal(g, x)


def test_step_equals_the_plain_march(mapped, monkeypatch):
    """The step's hybrid framebuffer (its band through the kernel on every
    frame) equals render_cone_hybrid with the eager loop, word for word."""
    cfg, state, out, launches = mapped
    assert launches == FRAMES
    _plain(monkeypatch)
    before = band_ops.LAUNCHES["band_march"]
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
    assert band_ops.LAUNCHES["band_march"] == before
    assert torch.equal(out.framebuffer, want)
    assert float(want[..., 3].max()) > 0.0


def test_knobs_stay_eager_on_the_card(mapped):
    """The compacting march and crawl > 1 run the eager loop on the card
    too: no launch, band_eager counted."""
    cfg, state, _, _ = mapped
    sel, z_first, spec, C, C2 = _band(cfg, state)
    before = band_ops.LAUNCHES["band_march"]
    for compact_after, crawl in ((8, 1), (999, 4)):
        _, c = _recorded(lambda: hybrid._march(
            sel, z_first, state.accel, state.pool.center,
            state.pool.half_size, state.pose, cfg.focal_x, cfg.focal_y,
            spec=spec, depth=cfg.max_depth,
            dist_level=pipeline._accel_level(cfg), max_range=cfg.max_range,
            start_dist=cfg.start_dist, band_iters=cfg.cone_band_iters,
            compact_after=compact_after, seed_halo=SEED_HALO, crawl=crawl,
            fused_dist=cfg.cone_band_fused_dist, C=C, C2=C2))
        assert c["band_eager"] == 1 and "band_kernel" not in c
    assert band_ops.LAUNCHES["band_march"] == before
