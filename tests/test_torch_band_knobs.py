"""Port parity: the hybrid's four band knobs (depth_prio, sel_decimate,
crawl, compact_after; octree_slam_tpu_torch/render/hybrid.py) against the
JAX package, on the map and slab image of tests/test_torch_hybrid.py, and
the step with each knob against the reference's step.

Tolerances (XLA:CPU may contract the luminance sum into FMAs, so lanes at
the cut of a top-C selection can differ, as test_torch_hybrid.py states):
  * band_march_merge on the same slab image, z_first and mirror: the
    selected sets agree on >= 99% of their lanes (sel_decimate: equal),
    the per-lane weights within 1e-3 on >= 99% of the common lanes, the
    image within 1e-4 on >= 99% of pixels, all finite;
  * the compacting march (compact_after < band_iters): both packages
    pack the live lanes into C/4 lanes once they fit; its image equals
    the port's fixed-trip march bit for bit, and its trip count is the
    reference's;
  * crawl 4 x 8 trips within 0.3 dB of crawl 1 x 32 against the exact
    march, on the reference's own scene for that contract
    (tests/test_hybrid.py:155-195);
  * the step: as tests/test_torch_pipeline.py holds it (pose within
    1e-4, counts and flags equal, 99% of pixels within 1e-4, the mirror's
    leaf level word for word)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import (DEVICE, assert_leaf_level_equal,
                          assert_step_parity, close_share, orbit_frames,
                          port_config, step_both, to_t)
from test_torch_hybrid import CFG, LVL, SPEC_KW, _band, scene  # noqa: F401

from octree_slam_tpu import pipeline as jpipeline
from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu.render import conesplat as jcs
from octree_slam_tpu.render import hybrid as jhybrid
from octree_slam_tpu.render import raycast as jraycast
from octree_slam_tpu_torch import convert, pipeline
from octree_slam_tpu_torch.render import conesplat as cs
from octree_slam_tpu_torch.render import hybrid
from octree_slam_tpu_torch.sensor import sources


def _port_band(tstate, aux, **kw):
    return hybrid.band_march_merge(
        to_t(aux[0]), to_t(aux[2]), tstate.accel, tstate.pool.center,
        tstate.pool.half_size, tstate.pose, CFG.focal_x, CFG.focal_y,
        spec=cs.make_slab_spec(**SPEC_KW), depth=CFG.max_depth,
        dist_level=LVL, debug_band=True, **kw)


def _assert_band_close(jout, jdbg, tout, tdbg, same_sel=False):
    jsel, tsel = np.asarray(jdbg["sel"]), tdbg["sel"].numpy()
    assert tsel.shape == jsel.shape and (np.diff(tsel) > 0).all()
    if same_sel:
        np.testing.assert_array_equal(tsel, jsel)
    common = np.intersect1d(jsel, tsel)
    assert len(common) >= 0.99 * len(jsel), (len(common), len(jsel))
    ji, ti = np.searchsorted(jsel, common), np.searchsorted(tsel, common)
    assert close_share(tdbg["w"].numpy()[ti], np.asarray(jdbg["w"])[ji],
                       tol=1e-3) >= 0.99
    assert bool(torch.isfinite(tout).all())
    assert close_share(tout, jout) >= 0.99


def test_depth_prio_matches(scene):
    jstate, tstate, aux = scene
    jout, jdbg, tout, tdbg = _band(jstate, tstate, aux, depth_prio=0.5,
                                   fused_dist=True)
    _assert_band_close(jout, jdbg, tout, tdbg)
    # the depth term moved the band
    _, plain = _port_band(tstate, aux, band_iters=12, fused_dist=True)
    assert not torch.equal(plain["sel"], tdbg["sel"])


@pytest.mark.parametrize("depth_prio", [0.0, 0.5])
def test_sel_decimate_selects_the_reference_lanes(scene, depth_prio):
    """The stride-2 pooled top-C/4, padded as XLA's SAME window pads (1
    before, 2 after for 5x5), each block expanded to its 2x2 pixels."""
    jstate, tstate, aux = scene
    jout, jdbg, tout, tdbg = _band(jstate, tstate, aux, sel_decimate=True,
                                   depth_prio=depth_prio, fused_dist=True)
    _assert_band_close(jout, jdbg, tout, tdbg, same_sel=True)
    sel = tdbg["sel"]
    blocks = torch.unique((sel // CFG.width // 2) * CFG.width
                          + (sel % CFG.width) // 2)
    assert blocks.numel() * 4 == sel.numel()       # whole 2x2 blocks
    # a band of C % 4 != 0 lanes falls back to the full top-C
    _, odd = _port_band(tstate, aux, band_iters=12, band_cap=401,
                        sel_decimate=True, depth_prio=depth_prio)
    _, full = _port_band(tstate, aux, band_iters=12, band_cap=401,
                         depth_prio=depth_prio)
    assert torch.equal(odd["sel"], full["sel"])


@pytest.mark.parametrize("crawl,fused", [(2, False), (4, True)])
def test_crawl_matches(scene, crawl, fused):
    jstate, tstate, aux = scene
    jout, jdbg, tout, tdbg = _band(jstate, tstate, aux, crawl=crawl,
                                   fused_dist=fused)
    _assert_band_close(jout, jdbg, tout, tdbg)
    assert 0 < int(tdbg["capped"].sum()) < tdbg["capped"].numel()


def test_compacting_march_is_the_fixed_trip_image(scene):
    jstate, tstate, aux = scene
    jout, jdbg, tout, tdbg = _band(jstate, tstate, aux, compact_after=4,
                                   fused_dist=True)
    _assert_band_close(jout, jdbg, tout, tdbg)
    assert tdbg["trips"] == int(jdbg["trips"])
    fixed, fdbg = _port_band(tstate, aux, band_iters=CFG.cone_band_iters,
                             fused_dist=True)
    assert torch.equal(tout, fixed)
    for name in ("w", "capped", "use_march"):
        assert torch.equal(tdbg[name], fdbg[name]), name
    # crawl is ignored by the compacting march, as in the reference
    again, _ = _port_band(tstate, aux, band_iters=CFG.cone_band_iters,
                          compact_after=4, crawl=4, fused_dist=True)
    assert torch.equal(again, fixed)
    # a long cap ends early, when no lane is live
    long, ldbg = _port_band(tstate, aux, band_iters=400, compact_after=4,
                            fused_dist=True)
    assert ldbg["trips"] < 400 and not bool(ldbg["capped"].any())


def test_crawl_within_0p3_db_of_single_samples():
    """crawl=4 x 8 trips against crawl=1 x 32 trips (the same samples,
    batched), each against the exact march, on the reference's own scene
    for this contract: six hybrid frames at 80x60, depth 7, 4 cm leaves
    (on the 64x48 map above, the reference itself misses the bound)."""
    cfg = port_config(SLAMConfig(
        width=80, height=60, focal_x=70.0, focal_y=70.0, pyramid_depth=2,
        pyramid_iters=(4, 4), voxel_resolution=0.04, max_depth=7,
        node_capacity=1 << 17, leaf_capacity=1 << 15, max_march_iters=64))
    scene_ = sources.default_scene(DEVICE)
    state = pipeline.init_state(
        cfg, initial_pose=sources.orbit_pose(0.0, device=DEVICE),
        device=DEVICE)
    for i in range(6):
        frame = sources.render_frame(
            scene_, sources.orbit_pose(i * 0.015, radius=2.0, device=DEVICE),
            cfg.focal_x, cfg.focal_y, width=cfg.width, height=cfg.height)
        state, out = pipeline.step(state, frame, cfg, render="cone_hybrid")
    _, march = pipeline.step(convert.clone_state(state), frame, cfg,
                             render="cone_march")
    lvl = pipeline._accel_level(cfg)

    def psnr(iters, crawl):
        fb = hybrid.render_cone_hybrid(
            state.leaves, state.accel, state.pool.center,
            state.pool.half_size, out.pose, cfg.focal_x, cfg.focal_y,
            spec=pipeline._slab_spec(cfg), depth=cfg.max_depth,
            dist_level=lvl, band_iters=iters, crawl=crawl)
        mse = float(((fb[..., :3] - march.framebuffer[..., :3]) ** 2).mean())
        return 10.0 * np.log10(1.0 / max(mse, 1e-12))

    p1, p4 = psnr(32, 1), psnr(8, 4)
    assert p4 > p1 - 0.3, (p1, p4)


def test_crawl_gap_is_the_references(scene):
    """On the 64x48 map the reference's crawl 4 x 6 lands more than 0.3 dB
    below its crawl 1 x 24 (against the exact march of the healed map);
    the port's lands where the reference's does."""
    jstate, tstate, aux = scene
    _, jcache = jpipeline.heal_for_march(jstate, CFG)
    march = np.asarray(jraycast.cone_trace_dense(
        jcache, jstate.pool.center, jstate.pool.half_size, jstate.pose,
        CFG.focal_x, CFG.focal_y, width=CFG.width, height=CFG.height,
        max_depth=CFG.max_depth, dist_level=LVL, max_iters=64,
        max_range=CFG.max_range, start_dist=CFG.start_dist))

    def psnr(fb):
        d = np.asarray(fb)[..., :3] - march[..., :3]
        return 10.0 * np.log10(1.0 / max(float((d ** 2).mean()), 1e-12))

    def jax_band(iters, crawl):
        return jax.jit(lambda f, z, c: jhybrid.band_march_merge(
            f, z, c, jstate.pool.center, jstate.pool.half_size, jstate.pose,
            CFG.focal_x, CFG.focal_y, spec=jcs.make_slab_spec(**SPEC_KW),
            depth=CFG.max_depth, dist_level=LVL, band_iters=iters,
            crawl=crawl, fused_dist=True))(
                jnp.asarray(aux[0]), jnp.asarray(aux[2]), jstate.accel)

    gaps = []
    for render in (jax_band, lambda iters, crawl: _port_band(
            tstate, aux, band_iters=iters, crawl=crawl, fused_dist=True)[0]):
        p = [psnr(render(iters, k)) for iters, k in ((24, 1), (6, 4))]
        gaps.append(p[0] - p[1])
    assert gaps[0] > 0.3, gaps                    # the reference's own gap
    assert abs(gaps[1] - gaps[0]) < 0.02, gaps


KNOBS = [{"cone_band_depth_prio": 0.5}, {"cone_band_sel_decimate": True},
         {"cone_band_crawl": 3}, {"cone_band_compact_after": 4}]


@pytest.fixture(scope="module")
def stream():
    return orbit_frames(CFG, 3)


@pytest.mark.parametrize("change", KNOBS, ids=lambda c: next(iter(c)))
def test_step_with_knob_matches_reference(stream, change):
    cfg = dataclasses.replace(CFG, **change)
    tcfg = port_config(cfg)
    pipeline.check_supported(tcfg, "cone_hybrid")
    gt = stream[2]
    jstate = jpipeline.init_state(cfg, initial_pose=jnp.asarray(gt[0]))
    tstate = pipeline.init_state(tcfg, initial_pose=to_t(gt[0]),
                                 device=DEVICE)
    for i in range(3):
        jstate, jo, tstate, to = step_both(jstate, tstate, cfg, tcfg, stream,
                                           i, "cone_hybrid")
        assert_step_parity(tstate, to, jstate, jo, f"{change} frame {i}")
        assert_leaf_level_equal(tstate.accel, jstate.accel, cfg.max_depth,
                                f"{change} frame {i}")
    assert float((to.framebuffer[..., :3].sum(-1) > 0).float().mean()) > 0.3
