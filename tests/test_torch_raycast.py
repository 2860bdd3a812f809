"""Port parity: the exact cone marchers
(octree_slam_tpu_torch/render/raycast.py) against the JAX package on one
JAX-built map (two eager inserts of points on a sphere and a wall), carried
to the port as numpy arrays.

Tolerances:
  * `build_accel`'s entry grid: bit-identical.
  * `make_rays`, `_ray_box`: within 1e-6.
  * `cone_trace_dense` and `cone_trace` (with and without the entry grid):
    at least 99% of pixels within 1e-4 on every channel, all finite. The
    marches differ from the JAX package's only where XLA contracts
    `origin + dirs * t` into an FMA or its log2 differs in the last ulp,
    which moves a sample across a cell boundary at isolated pixels. The
    per-pixel finishing trip agrees on at least 99% of pixels and each
    phase's trip count within 2.
  * the march's exit test read every trip, every 4 and every 7 trips:
    bit-identical images, and the same needed-trip counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import DEVICE, close_share, to_t

from octree_slam_tpu.map import mips as jmips
from octree_slam_tpu.map import svo as jsvo
from octree_slam_tpu.render import raycast as jrc
from octree_slam_tpu_torch.map import mips, svo
from octree_slam_tpu_torch.render import raycast as rc

DEPTH, LVL, CAP, W, H, F = 6, 4, 1 << 14, 64, 48, 30.0
HALF = 0.05 * 2 ** (DEPTH - 1)
# the short focal length puts the cone's level of detail at 5 beyond 1.5 m
# and at 6 (the leaves) before it, so both sides of the LOD rule are marched
MARCH = dict(width=W, height=H, max_depth=DEPTH, max_iters=40,
             max_range=6.0)


def _cloud(seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(500, 3))
    sphere = 0.45 * d / np.linalg.norm(d, axis=1, keepdims=True) \
        + (0.2, 0.0, 0.3)
    wall = np.stack([rng.uniform(-1.2, 1.2, 500), rng.uniform(-0.9, 0.9, 500),
                     np.full(500, 1.1)], -1)
    pts = np.concatenate([sphere, wall]).astype(np.float32)
    return pts, rng.uniform(0, 1, pts.shape).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    jpool = jsvo.create(CAP, jnp.zeros(3), jnp.float32(HALF))
    jcache = jmips.create(max_depth=DEPTH, dist_level=LVL, max_skip=5)
    for seed in (1, 2):
        pts, cols = _cloud(seed)
        jpool, st = jsvo.insert(jpool, jnp.asarray(pts), jnp.asarray(cols),
                                depth=DEPTH, unique_cap=1 << 11,
                                emit_mips=True, shallow_level=LVL)
        jcache = jmips.update(jcache, st.mip_idx, st.mip_val,
                              max_depth=DEPTH, dist_level=LVL, max_skip=5)
    assert not bool(jpool.overflowed)
    tpool = svo.SVONodePool(*(to_t(np.asarray(x)) for x in jpool))
    tcache = mips.RenderCache(*(to_t(np.asarray(x)) for x in jcache))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.05, 0.02, -1.2)
    return jpool, jcache, tpool, tcache, pose


def test_make_rays_and_ray_box(scene):
    pose = scene[4]
    jo, jd = jrc.make_rays(jnp.asarray(pose), F, F, W, H)
    to, td = rc.make_rays(to_t(pose), F, F, W, H)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    lo, hi = np.full(3, -0.5, np.float32), np.full(3, 0.5, np.float32)
    dirs = np.asarray(jd).copy()
    dirs[:7] = (0.0, 0.0, 1.0)                    # axis-parallel rays
    for origin in ((0.05, 0.02, -1.2), (0.0, 0.0, 0.0), (0.7, 0.0, -1.2)):
        o = np.asarray(origin, np.float32)
        with np.errstate(divide="ignore"):
            inv = np.where(np.abs(dirs) > 1e-9, 1.0 / dirs, np.inf)
        j0, j1 = jrc._ray_box(jnp.asarray(o), jnp.asarray(dirs),
                              jnp.asarray(inv), jnp.asarray(lo),
                              jnp.asarray(hi))
        t0, t1 = rc._ray_box(to_t(o), to_t(dirs), to_t(inv), to_t(lo),
                             to_t(hi))
        np.testing.assert_allclose(t0.numpy(), np.asarray(j0), atol=1e-6)
        np.testing.assert_allclose(t1.numpy(), np.asarray(j1), atol=1e-6)


def test_build_accel_bit_identical(scene):
    jpool, _, tpool, *_ = scene
    for level in (3, LVL):
        got = rc.build_accel(tpool, level=level)
        np.testing.assert_array_equal(
            got.entry.numpy(),
            np.asarray(jrc.build_accel(jpool, level=level).entry))
        assert got.level == level
    assert int(((got.entry & 15) == LVL).sum()) > 50


def test_cone_trace_dense_matches(scene):
    _, jcache, _, tcache, pose = scene
    jfb, jdbg = jrc.cone_trace_dense(
        jcache, jnp.zeros(3), jnp.float32(HALF), jnp.asarray(pose), F, F,
        dist_level=LVL, debug_iters=True, **MARCH)
    tfb, tdbg = rc.cone_trace_dense(
        tcache, torch.zeros(3), torch.tensor(HALF), to_t(pose), F, F,
        dist_level=LVL, debug_iters=True, **MARCH)
    assert tfb.shape == (H, W, 4) and bool(torch.isfinite(tfb).all())
    assert close_share(tfb, jfb) >= 0.99
    assert float((tfb[..., :3].sum(-1) > 0).float().mean()) > 0.2
    assert (tdbg["fin"].numpy() == np.asarray(jdbg["fin"])).mean() >= 0.99
    for name in ("p1_trips", "p2_trips"):
        assert abs(int(tdbg[name]) - int(jdbg[name])) <= 2, name
    assert 0 < int(tdbg["p2_trips"]) < MARCH["max_iters"]
    # the compacted march is the uncompacted one bit for bit, in both
    # packages
    jc = jrc.cone_trace_dense(
        jcache, jnp.zeros(3), jnp.float32(HALF), jnp.asarray(pose), F, F,
        dist_level=LVL, compact_after=2, compact_cap=1024, **MARCH)
    np.testing.assert_array_equal(np.asarray(jc), np.asarray(jfb))
    tc = rc.cone_trace_dense(
        tcache, torch.zeros(3), torch.tensor(HALF), to_t(pose), F, F,
        dist_level=LVL, compact_after=2, compact_cap=1024, **MARCH)
    assert torch.equal(tc, tfb)


@pytest.mark.parametrize("use_accel", [True, False])
def test_cone_trace_matches(scene, use_accel):
    jpool, _, tpool, _, pose = scene
    ja = jrc.build_accel(jpool, level=LVL) if use_accel else None
    ta = rc.build_accel(tpool, level=LVL) if use_accel else None
    jfb = jrc.cone_trace(jpool, jnp.asarray(pose), F, F, accel=ja,
                         accel_level=LVL, **MARCH)
    tfb = rc.cone_trace(tpool, to_t(pose), F, F, accel=ta, accel_level=LVL,
                        **MARCH)
    assert bool(torch.isfinite(tfb).all())
    assert close_share(tfb, jfb) >= 0.99
    assert float((tfb[..., :3].sum(-1) > 0).float().mean()) > 0.2


def test_exit_check_period_changes_nothing(scene):
    _, _, tpool, tcache, pose = scene
    dense, ptr = [], []
    for every in (1, 4, 7):
        dense.append(rc.cone_trace_dense(
            tcache, torch.zeros(3), torch.tensor(HALF), to_t(pose), F, F,
            dist_level=LVL, debug_iters=True, exit_check_every=every,
            **MARCH))
        ptr.append(rc.cone_trace(tpool, to_t(pose), F, F, accel=None,
                                 exit_check_every=every, **MARCH))
    for (fb, dbg), p in zip(dense[1:], ptr[1:]):
        assert torch.equal(fb, dense[0][0]) and torch.equal(p, ptr[0])
        for name in ("p1_trips", "p2_trips", "fin"):
            assert torch.equal(dbg[name], dense[0][1][name]), name


def test_spread_table_and_to_u8():
    v = torch.arange(1 << DEPTH, dtype=torch.int32)
    tab = rc._spread3(DEPTH, "cpu")
    x, y, z = v, v.flip(0), (v * 5) % (1 << DEPTH)
    assert torch.equal(tab[x.long()] | (tab[y.long()] << 1)
                       | (tab[z.long()] << 2),
                       mips.interleave3(x, y, z, DEPTH))
    fb = np.random.default_rng(0).uniform(-0.2, 1.2, (5, 7, 4)).astype(
        np.float32)
    got = rc.to_u8(to_t(fb))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jrc.to_u8(jnp.asarray(fb))))
