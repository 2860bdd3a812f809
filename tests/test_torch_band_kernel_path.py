"""Which path the hybrid band's trips take (render/hybrid.py `_band_kernel`)
and the checks of the band kernel's wrapper (render/band_ops.py), on the
CPU at slambench's CPU cut of room2cm_hybrid (tests/test_torch_band_stage.py):
the CPU runs the eager loop and counts `band_eager` on every call, never
`band_kernel`, and launches nothing; on a CUDA device the kernel takes the
fixed-trip march with one sample a trip, and the compacting march and
crawl > 1 stay eager; the wrapper raises on a wrong dtype, shape, layout,
depth or device before it builds or launches anything. The kernel itself
runs only on the card (tests/test_torch_cuda_band_march.py).

Tolerances: none; counts are compared exactly."""

import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from test_torch_band_stage import CFG, FRAMES, orbit  # noqa: F401

from octree_slam_tpu_torch import app, pipeline
from octree_slam_tpu_torch.map import mips
from octree_slam_tpu_torch.render import band_ops, conesplat, hybrid
from octree_slam_tpu_torch.utils import spans


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.stop()
    yield
    spans.stop()


def test_cpu_runs_the_eager_loop_on_every_hybrid_frame(orbit):
    """run_slam at render_every 2: every hybrid frame counts band_eager
    once and no band_kernel; no kernel launch."""
    frames, poses = orbit
    before = dict(band_ops.LAUNCHES)
    spans.start()
    app.run_slam(lambda i: frames[i], FRAMES, CFG, initial_pose=poses[0],
                 device="cpu", render_every=2, render_mode="cone_hybrid")
    rec = spans.stop()
    assert rec.frames == list(range(FRAMES))
    assert rec.counter("band_eager") == {i: int(i % 2 == 0)
                                         for i in rec.frames}
    assert set(rec.counter("band_kernel").values()) == {0}
    assert band_ops.LAUNCHES == before


@pytest.mark.parametrize("device,C,compact_after,iters,crawl,kernel", [
    ("cuda", 3600, 999, 24, 1, True),     # the production shape
    ("cuda", 3600, 24, 24, 1, True),      # compact_after at the cap
    ("cuda", 128, 4, 24, 1, True),        # C2 >= C: never packs
    ("cuda", 3600, 8, 24, 1, False),      # the compacting march
    ("cuda", 3600, 999, 24, 4, False),    # crawl > 1
    ("cpu", 3600, 999, 24, 1, False),     # the CPU
])
def test_which_path_the_trips_take(device, C, compact_after, iters, crawl,
                                   kernel):
    """_band_kernel decides by what the call observes: the device, the
    march's shape and crawl."""
    C2 = max(128, C // 4)
    assert hybrid._band_kernel(torch.device(device), C, C2, compact_after,
                               iters, crawl) is kernel


def _slab(orbit):
    frames, poses = orbit
    state = pipeline.init_state(CFG, initial_pose=poses[0], device="cpu")
    for f in frames[:2]:
        state, _ = pipeline.step(state, f, CFG, render="cone_hybrid")
    fb, _, z_first = conesplat.render_cone_splat(
        state.leaves, state.pool.center, state.pool.half_size, state.pose,
        CFG.focal_x, CFG.focal_y, spec=pipeline._slab_spec(CFG),
        depth=CFG.max_depth, want_aux=True)
    return state, fb, z_first


@pytest.mark.parametrize("compact_after,crawl", [(999, 1), (4, 1),
                                                 (999, 4)])
def test_band_march_merge_counts_its_path(orbit, compact_after, crawl):
    """band_march_merge on the CPU: one band_eager a call whatever the
    knobs, no band_kernel, no launch."""
    state, fb, z_first = _slab(orbit)
    before = dict(band_ops.LAUNCHES)
    spans.start()
    with spans.frame(0):
        for _ in range(2):
            hybrid.band_march_merge(
                fb, z_first, state.accel, state.pool.center,
                state.pool.half_size, state.pose, CFG.focal_x, CFG.focal_y,
                spec=pipeline._slab_spec(CFG), depth=CFG.max_depth,
                dist_level=pipeline._accel_level(CFG),
                band_cap=CFG.cone_band_cap, band_iters=CFG.cone_band_iters,
                compact_after=compact_after, crawl=crawl, fused_dist=True)
    c = spans.stop().counters[0]
    assert c["band_eager"] == 2 and "band_kernel" not in c
    assert band_ops.LAUNCHES == before


def _inputs(C=8, depth=7, dist_level=5):
    """Valid band_march arguments on the CPU, as (args, kwargs)."""
    dirs = torch.nn.functional.normalize(torch.randn(C, 3), dim=-1)
    cache = mips.create(max_depth=depth, dist_level=dist_level,
                        device="cpu")
    args = dict(origin=torch.zeros(3), dirs=dirs, inv_dirs=1.0 / dirs,
                limit=torch.full((C,), 5.0), start=torch.full((C,), 0.002),
                miss=torch.zeros(C, dtype=torch.bool), cache=cache,
                center=torch.zeros(3), half_size=torch.tensor(2.56))
    kw = dict(depth=depth, dist_level=dist_level, max_range=10.0,
              band_iters=8, fused_dist=True)
    return args, kw


@pytest.mark.parametrize("fault,error,match", [
    ("dirs_f64", TypeError, "dirs of torch.float32"),
    ("dirs_shape", ValueError, "dirs of shape"),
    ("inv_dirs_strided", ValueError, "inv_dirs must be contiguous"),
    ("limit_length", ValueError, "limit of shape"),
    ("miss_float", TypeError, "miss of torch.bool"),
    ("values_f32", TypeError, "cache.values of torch.int32"),
    ("dist_size", ValueError, "dist holds"),
    ("half_size_shape", ValueError, "half_size of shape"),
    ("origin_shape", TypeError, "origin f32"),
    ("depth_11", ValueError, "depth 11"),
    ("iters_negative", ValueError, "band_iters -1"),
    ("cpu", ValueError, "expected CUDA tensors"),
])
def test_the_wrapper_raises(fault, error, match):
    """Each wrong argument raises before anything is built or launched; a
    valid call on CPU tensors raises for the device."""
    args, kw = _inputs()
    C = args["dirs"].shape[0]
    cache = args["cache"]
    change = {
        "dirs_f64": lambda: args.update(dirs=args["dirs"].double()),
        "dirs_shape": lambda: args.update(dirs=args["dirs"][:, :2]
                                          .contiguous()),
        "inv_dirs_strided": lambda: args.update(
            inv_dirs=torch.zeros(3, C).t()),
        "limit_length": lambda: args.update(limit=torch.ones(C + 1)),
        "miss_float": lambda: args.update(miss=torch.zeros(C)),
        "values_f32": lambda: args.update(
            cache=cache._replace(values=cache.values.float())),
        "dist_size": lambda: args.update(
            cache=cache._replace(dist=cache.dist[:-1])),
        "half_size_shape": lambda: args.update(half_size=torch.ones(1)),
        "origin_shape": lambda: args.update(origin=torch.zeros(4)),
        "depth_11": lambda: kw.update(depth=11),
        "iters_negative": lambda: kw.update(band_iters=-1),
        "cpu": lambda: None,
    }[fault]
    change()
    before = dict(band_ops.LAUNCHES)
    with pytest.raises(error, match=match):
        band_ops.band_march(**args, **kw)
    assert band_ops.LAUNCHES == before

