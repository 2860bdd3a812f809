"""Port parity: the live-ray compaction of the exact march
(octree_slam_tpu_torch/render/raycast.cone_trace_dense) and of the hybrid's
compacting band march (render/hybrid.band_march_merge), and the partition
they pack the live lanes with (utils/compaction.live_first).

Tolerances:
  * `live_first`: equal to numpy's stable argsort of "live first", cut to
    C lanes.
  * the compacted march against the port's all-lanes march, and the
    compacting band march against the port's fixed-trip one: bit for bit
    (a lane's arithmetic does not depend on the lanes beside it).
  * the compacted march against the JAX package's compacted march on the
    same map: at least 99% of pixels within 1e-4, as
    tests/test_torch_raycast.py holds the all-lanes marches; the band march
    as tests/test_torch_band_knobs.py holds it, with the JAX package's trip
    count.

The map is tests/test_mips.py's half-frame wall (64x48, depth 6), built by
the JAX package and carried to the port as numpy arrays: half the rays
graze or miss it, which leaves a live tail to compact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import close_share, to_t
from test_mips import DEPTH, insert_cloud, make_pool
from test_torch_band_knobs import _assert_band_close, _port_band
from test_torch_hybrid import CFG, LVL, SPEC_KW, scene  # noqa: F401

from octree_slam_tpu.map import mips as jmips
from octree_slam_tpu.render import conesplat as jcs
from octree_slam_tpu.render import hybrid as jhybrid
from octree_slam_tpu.render import raycast as jrc
from octree_slam_tpu_torch.map import mips
from octree_slam_tpu_torch.render import raycast as rc
from octree_slam_tpu_torch.utils import compaction

W, H, F = 64, 48, 50.0
N = W * H
KW = dict(width=W, height=H, max_depth=DEPTH, max_iters=48, max_range=4.0,
          dist_level=4, max_skip=5)


@pytest.fixture(scope="module")
def wall():
    """(JAX pool, JAX mirror, port mirror, pose): six inserts of a wall
    over the left half of the view, partial alpha for long tails."""
    pool = make_pool()
    cache = jmips.create(max_depth=DEPTH, dist_level=4, max_skip=5)
    rng = np.random.default_rng(7)
    xs = rng.uniform(-0.4, 0.05, 3000)
    ys = rng.uniform(-0.4, 0.4, 3000)
    pts = np.stack([xs, ys, np.full_like(xs, 0.3)], -1).astype(np.float32)
    cols = rng.uniform(0, 1, (3000, 3)).astype(np.float32)
    for _ in range(6):
        pool, _, cache = insert_cloud(pool, pts, cols, cache)
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = -0.4
    tcache = mips.RenderCache(*(to_t(np.asarray(x)) for x in cache))
    return pool, cache, tcache, pose


@pytest.fixture
def packs(monkeypatch):
    """(lanes, capacity, live lanes) of every live_first call the test
    makes."""
    calls = []

    def spy(active, count):
        calls.append((active.numel(), count, int(active.sum())))
        return live_first(active, count)

    live_first = compaction.live_first
    monkeypatch.setattr(compaction, "live_first", spy)
    return calls


def _port(wall, **kw):
    _, _, tcache, pose = wall
    return rc.cone_trace_dense(
        tcache, torch.zeros(3), torch.tensor(0.02 * 2 ** (DEPTH - 1)),
        to_t(pose), F, F, **{**KW, **kw})


@pytest.mark.parametrize("p_live,count", [
    (1.0, 300),    # all live
    (0.0, 300),    # none live
    (0.1, 300),    # fewer live lanes than the capacity
    (0.6, 300)])   # more
def test_live_first_is_the_stable_sort(p_live, count):
    rng = np.random.default_rng(int(p_live * 10) + count)
    active = rng.uniform(size=1000) < p_live
    got = compaction.live_first(torch.from_numpy(active), count)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(
        got.numpy(),
        np.argsort(np.where(active, 0, 1), kind="stable")[:count])


@pytest.mark.parametrize("compact_after,compact_cap,cap", [
    (4, 512, 512),
    (12, None, N // 4)])   # the defaults: 768 of the 3,072 lanes
def test_compacted_march_is_the_all_lanes_march(wall, packs, compact_after,
                                                compact_cap, cap):
    all_lanes = _port(wall, compact_after=KW["max_iters"])
    assert not packs
    got = _port(wall, compact_after=compact_after, compact_cap=compact_cap)
    assert len(packs) == 1
    lanes, count, live = packs[0]
    assert (lanes, count) == (N, cap) and 0 < live <= cap
    assert torch.equal(got, all_lanes)
    assert float((got[..., :3].sum(-1) > 0).float().mean()) > 0.2


def test_compacted_march_matches_the_reference(wall, packs):
    pool, cache, _, pose = wall
    jfb = jrc.cone_trace_dense(cache, pool.center, pool.half_size,
                               jnp.asarray(pose), F, F, **KW)
    got = _port(wall)
    assert len(packs) == 1
    assert bool(torch.isfinite(got).all())
    assert close_share(got, jfb) >= 0.99


@pytest.mark.parametrize("kw", [
    dict(compact_cap=N),                     # C >= n
    dict(compact_after=KW["max_iters"]),     # compact_after >= max_iters
    dict(debug_iters=True)])                 # per-pixel fin wants all lanes
def test_cases_that_do_not_compact(wall, packs, kw):
    got = _port(wall, **{"compact_after": 4, **kw})
    if kw.get("debug_iters"):
        got, dbg = got
        assert int(dbg["p2_trips"]) > 4    # a tail there was to compact
    assert not packs
    assert torch.equal(got, _port(wall))


@pytest.mark.parametrize("band_iters,packed", [
    (CFG.cone_band_iters, False),   # 544 of 768 lanes live at the cap
    (96, True)])
def test_compacting_band_march(scene, packs, band_iters,  # noqa: F811
                               packed):
    """compact_after=4 against the JAX package's band_march_merge, and
    against the port's fixed-trip march over all C lanes bit for bit. At
    the config's 12 trips the live lanes never fit C/4; at 96 they do."""
    jstate, tstate, aux = scene
    kw = dict(band_iters=band_iters, compact_after=4, fused_dist=True)
    jout, jdbg = jax.jit(
        lambda f, z, c: jhybrid.band_march_merge(
            f, z, c, jstate.pool.center, jstate.pool.half_size, jstate.pose,
            CFG.focal_x, CFG.focal_y, spec=jcs.make_slab_spec(**SPEC_KW),
            depth=CFG.max_depth, dist_level=LVL, max_range=CFG.max_range,
            start_dist=CFG.start_dist, debug_band=True, **kw))(
        jnp.asarray(aux[0]), jnp.asarray(aux[2]), jstate.accel)
    tout, tdbg = _port_band(tstate, aux, **kw)
    C = max(128, N // 4)
    assert [(lanes, count) for lanes, count, _ in packs] \
        == [(C, C // 4)] * packed
    assert (tdbg["packed_at"] >= 4) == packed
    _assert_band_close(jout, jdbg, tout, tdbg)
    assert tdbg["trips"] == int(jdbg["trips"])
    fixed, fdbg = _port_band(tstate, aux, band_iters=band_iters,
                             fused_dist=True)
    assert torch.equal(tout, fixed)
    for name in ("w", "capped", "use_march"):
        assert torch.equal(tdbg[name], fdbg[name]), name
