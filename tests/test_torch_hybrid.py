"""Port parity: the hybrid cone renderer
(octree_slam_tpu_torch/render/hybrid.py) and the free-cell distance stamps
(mips.encode_free_dist) against the JAX package, on a map that three
hybrid frames of the JAX pipeline built (64x48, depth 6) and that crosses
to the port as numpy arrays (the window pools and the empty map are in
tests/test_torch_hybrid_pools.py).

Tolerances:
  * `encode_free_dist`: word for word, and a second run changes nothing.
  * `band_march_merge` on the same slab image, z_first and mirror: XLA:CPU
    may contract the luminance sum into FMAs, so lanes next to the cut of
    the top-C selection can differ: the selected *sets* agree on >= 99% of
    their lanes; on the common lanes the march's start agrees within 1e-5
    and the capped flags on >= 99%; the image within 1e-4 on >= 99% of
    pixels, all finite.
  * fused (one gather a trip) against unfused (a second gather of
    `cache.dist`): bit for bit, image and per-lane weights.
  * `render_cone_splat(want_aux=True)` on the pipeline's registry: image,
    w_acc and z_first within 1e-4 on >= 99% of pixels, and z_first only
    takes slab boundaries or +inf."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import (DEVICE, close_share, orbit_frames, port_config,
                          to_t, words)

from octree_slam_tpu import pipeline as jpipeline
from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu.map import mips as jmips
from octree_slam_tpu.render import conesplat as jcs
from octree_slam_tpu.render import hybrid as jhybrid
from octree_slam_tpu.sensor import sources as jsources
from octree_slam_tpu_torch import convert, pipeline
from octree_slam_tpu_torch.map import mips
from octree_slam_tpu_torch.render import conesplat as cs
from octree_slam_tpu_torch.render import hybrid

CFG = SLAMConfig(width=64, height=48, focal_x=55.0, focal_y=55.0,
                 pyramid_depth=2, pyramid_iters=(6, 6),
                 voxel_resolution=0.05, max_depth=6, node_capacity=1 << 14,
                 leaf_capacity=1 << 12, insert_unique_cap=1 << 10)
TCFG = port_config(CFG)
LVL = 4   # pipeline._accel_level(CFG)
SPEC_KW = dict(width=CFG.width, height=CFG.height, fx=CFG.focal_x,
               leaf_size=CFG.voxel_resolution, z_near=CFG.cone_znear,
               z_far=CFG.max_range, n_slabs=CFG.cone_slabs,
               max_scale=CFG.cone_max_scale)


@pytest.fixture(scope="module")
def scene():
    """(JAX state, port state, JAX slab image / w_acc / z_first as numpy)
    after three hybrid frames: a current, stamped mirror."""
    depth, color, gt = orbit_frames(CFG, 3)
    jstate = jpipeline.init_state(CFG, initial_pose=jnp.asarray(gt[0]))
    for i in range(3):
        jstate, _ = jpipeline.step(jstate, jsources.Frame(
            jnp.asarray(depth[i]), jnp.asarray(color[i]), jnp.float32(0)),
            CFG, render="cone_hybrid")
    assert not bool(jstate.mirror_stale) and not bool(jstate.stamps_stale)
    tstate = convert.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), TCFG, device=DEVICE)
    aux = jcs.render_cone_splat(
        jstate.leaves, jstate.pool.center, jstate.pool.half_size,
        jstate.pose, CFG.focal_x, CFG.focal_y,
        spec=jcs.make_slab_spec(**SPEC_KW), depth=CFG.max_depth,
        want_aux=True)
    return jstate, tstate, tuple(np.asarray(a) for a in aux)


def _band(jstate, tstate, aux, **kw):
    """band_march_merge of both packages on the JAX slab image."""
    fb, _, z_first = aux
    kw = dict(depth=CFG.max_depth, dist_level=LVL, max_range=CFG.max_range,
              start_dist=CFG.start_dist, band_iters=CFG.cone_band_iters,
              debug_band=True, **kw)
    jout, jdbg = jax.jit(
        lambda f, z, c: jhybrid.band_march_merge(
            f, z, c, jstate.pool.center, jstate.pool.half_size, jstate.pose,
            CFG.focal_x, CFG.focal_y, spec=jcs.make_slab_spec(**SPEC_KW),
            **kw))(jnp.asarray(fb), jnp.asarray(z_first), jstate.accel)
    tout, tdbg = hybrid.band_march_merge(
        to_t(fb), to_t(z_first), tstate.accel, tstate.pool.center,
        tstate.pool.half_size, tstate.pose, CFG.focal_x, CFG.focal_y,
        spec=cs.make_slab_spec(**SPEC_KW), **kw)
    return jout, jdbg, tout, tdbg


@pytest.mark.parametrize("stamped", [False, True])
def test_encode_free_dist_word_for_word(scene, stamped):
    """On a rebuilt mirror (no stamps) and on the hybrid frames' own
    (stamped: the stamp is idempotent)."""
    jstate, tstate, _ = scene
    if stamped:
        jcache, tcache = jstate.accel, convert.clone_state(tstate).accel
    else:
        _, jcache = jpipeline.heal_for_march(jstate, CFG)
        _, tcache = pipeline.heal_for_march(convert.clone_state(tstate), TCFG)
        assert int((words(tcache.values) < 256).sum()) == 0
    want = np.asarray(jmips.encode_free_dist(
        jcache, max_depth=CFG.max_depth, dist_level=LVL).values)
    buf = tcache.values.data_ptr()
    got = mips.encode_free_dist(tcache, max_depth=CFG.max_depth,
                                dist_level=LVL)
    assert got.values.data_ptr() == buf            # written in place
    np.testing.assert_array_equal(words(got.values), want)
    lo = mips.level_offset(CFG.max_depth)
    leaf = words(got.values)[lo:]
    assert 0 < int((leaf < 256).sum()) < leaf.size  # stamps and leaves
    assert int((leaf >> 24 > 127).sum()) == int(tstate.leaves.count)
    np.testing.assert_array_equal(             # interior levels untouched
        words(got.values)[:lo], np.asarray(jcache.values)[:lo])
    again = mips.encode_free_dist(got, max_depth=CFG.max_depth,
                                  dist_level=LVL)
    np.testing.assert_array_equal(words(again.values), want)
    if stamped:
        np.testing.assert_array_equal(want, np.asarray(jcache.values))


@pytest.mark.parametrize("fused,band_cap", [(True, 0), (False, 0),
                                            (True, 400), (True, 3072)])
def test_band_select_seeds_and_image_match(scene, fused, band_cap):
    jstate, tstate, aux = scene
    jout, jdbg, tout, tdbg = _band(jstate, tstate, aux, fused_dist=fused,
                                   band_cap=band_cap)
    n = CFG.width * CFG.height
    C = min(band_cap or max(128, n // 4), n)
    jsel, tsel = np.asarray(jdbg["sel"]), tdbg["sel"].numpy()
    assert tsel.shape == jsel.shape == (C,)
    assert (np.diff(tsel) > 0).all()               # unique, raster order
    common = np.intersect1d(jsel, tsel)
    assert len(common) >= 0.99 * C, (len(common), C)
    ji, ti = np.searchsorted(jsel, common), np.searchsorted(tsel, common)
    np.testing.assert_allclose(tdbg["seed_t"].numpy()[ti],
                               np.asarray(jdbg["seed_t"])[ji], rtol=1e-5,
                               atol=1e-6)
    same_cap = (tdbg["capped"].numpy()[ti]
                == np.asarray(jdbg["capped"])[ji]).mean()
    assert same_cap >= 0.99, same_cap
    assert close_share(tdbg["w"].numpy()[ti], np.asarray(jdbg["w"])[ji],
                       tol=1e-3) >= 0.99
    assert tdbg["trips"] == int(jdbg["trips"]) == CFG.cone_band_iters
    assert tout.shape == (CFG.height, CFG.width, 4)
    assert bool(torch.isfinite(tout).all())
    assert close_share(tout, jout) >= 0.99
    # the band changed the slab image, and only inside the band
    moved = (tout.numpy() != aux[0]).any(-1).reshape(-1)
    assert moved.any() and not moved[np.setdiff1d(np.arange(n), tsel)].any()
    # seeded rays start past the camera: the slab is the march's skip
    assert float(tdbg["seed_t"].max()) > 0.5


def test_fused_equals_unfused_bit_for_bit(scene):
    _, tstate, aux = scene
    outs = []
    for fused in (True, False):
        outs.append(hybrid.band_march_merge(
            to_t(aux[0]), to_t(aux[2]), tstate.accel, tstate.pool.center,
            tstate.pool.half_size, tstate.pose, CFG.focal_x, CFG.focal_y,
            spec=cs.make_slab_spec(**SPEC_KW), depth=CFG.max_depth,
            dist_level=LVL, band_iters=CFG.cone_band_iters,
            fused_dist=fused, debug_band=True))
    (fa, da), (fb, db) = outs
    assert torch.equal(fa, fb)
    for name in ("sel", "w", "capped", "use_march", "seed_t"):
        assert torch.equal(da[name], db[name]), name
    # both kinds of lane occur: finished by the march, and capped
    assert 0 < int(da["capped"].sum()) < da["capped"].numel()


def test_slab_aux_outputs_match_on_the_registry(scene):
    _, tstate, (jfb, jw, jz) = scene
    spec = cs.make_slab_spec(**SPEC_KW)
    tfb, tw, tz = cs.render_cone_splat(
        tstate.leaves, tstate.pool.center, tstate.pool.half_size,
        tstate.pose, CFG.focal_x, CFG.focal_y, spec=spec,
        depth=CFG.max_depth, want_aux=True)
    for got, want in ((tfb, jfb), (tw, jw), (tz, jz)):
        assert close_share(got, want) >= 0.99
    bounds = np.float32(spec.z_near) * np.float32(spec.ratio) ** np.arange(
        spec.n_slabs)
    z = tz.numpy()
    assert np.isinf(z).any() and np.isfinite(z).sum() > 0.3 * z.size
    near = np.abs(z[np.isfinite(z)][:, None] - bounds[None]).min(-1)
    assert float(near.max()) < 1e-5
    assert ((tw.numpy() > 0) == np.isfinite(z)).all()


def test_render_cone_hybrid_matches(scene):
    jstate, tstate, aux = scene
    kw = dict(depth=CFG.max_depth, dist_level=LVL, max_range=CFG.max_range,
              start_dist=CFG.start_dist, band_cap=CFG.cone_band_cap,
              band_iters=CFG.cone_band_iters, fused_dist=True)
    jfb = jhybrid.render_cone_hybrid(
        jstate.leaves, jstate.accel, jstate.pool.center,
        jstate.pool.half_size, jstate.pose, CFG.focal_x, CFG.focal_y,
        spec=jcs.make_slab_spec(**SPEC_KW), **kw)
    tfb = hybrid.render_cone_hybrid(
        tstate.leaves, tstate.accel, tstate.pool.center,
        tstate.pool.half_size, tstate.pose, CFG.focal_x, CFG.focal_y,
        spec=cs.make_slab_spec(**SPEC_KW), **kw)
    assert bool(torch.isfinite(tfb).all())
    assert close_share(tfb, jfb) >= 0.99
    assert float((tfb[..., :3].sum(-1) > 0).float().mean()) > 0.3
    assert close_share(tfb, aux[0]) < 1.0          # not the slab image
