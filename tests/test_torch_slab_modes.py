"""Port parity: the slab cone's three composite modes (accumulate, blend,
bilinear; octree_slam_tpu_torch/render/conesplat.py) against the JAX
package, on the leaf registry of tests/test_torch_conesplat.py.

Tolerances:
  * the scatter-add sums [w, w*r, w*g, w*b]: every term is an integer of at
    most 128 * 255 and every sum stays below 2^24, so on the same bins the
    two libraries' sums are equal bit for bit in any order; from each
    package's own binning they are equal but on the cells a borderline
    leaf can reach (the min words' rule in test_torch_conesplat.py);
  * `_double_bilinear`, the bilinear `_upsample`, `_composite_fields` and
    `composite_min_words` with bilinear=True on identical inputs: within
    1e-5 of the value's scale (XLA contracts the tent into FMAs);
  * `render_cone_splat` in each mode: at least 99% of pixels within 1e-5
    on every channel, all finite (the rest are pixels of borderline
    leaves); w_acc and z_first likewise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import close_share, to_t
from test_torch_conesplat import (DEPTH, FX, HALF, SPEC_KW, H, W,
                                  _borderline_cells, _fields, scene)  # noqa

from octree_slam_tpu.render import conesplat as jcs
from octree_slam_tpu_torch.render import conesplat as cs

MODES = [dict(accumulate=True), dict(blend=0.25), dict(bilinear=True),
         dict(accumulate=True, bilinear=True, dilate=0),
         dict(blend=1.0, bilinear=True)]


def _jax_bins_and_sums(jl, live, pose):
    """The reference's binning and its scatter-add, as render_cone_splat
    writes it (conesplat.py:367-382)."""
    (idx, ok, _, _), (r8, g8, b8, _, w_leaf), _ = jcs._slab_bins_and_words(
        jl.vals, jl.keys, jnp.asarray(live), jnp.zeros(3), jnp.float32(HALF),
        jnp.asarray(pose), FX, FX, spec=jcs.make_slab_spec(**SPEC_KW),
        depth=DEPTH)
    wf = jnp.where(ok, w_leaf.astype(jnp.float32), 0.0)
    vals = jnp.stack([wf, wf * r8.astype(jnp.float32),
                      wf * g8.astype(jnp.float32),
                      wf * b8.astype(jnp.float32)], axis=-1)
    total = jcs.make_slab_spec(**SPEC_KW).total_cells
    abuf = jnp.zeros((total, 4), jnp.float32).at[idx].add(vals, mode="drop")
    return (idx, ok, r8, g8, b8, w_leaf), np.asarray(abuf)


def test_scatter_add_sums(scene):
    jl, tl, keys, vals, n, pose = scene
    spec = cs.make_slab_spec(**SPEC_KW)
    live = (np.arange(len(keys)) < n) & (keys >= 0)
    (idx, ok, r8, g8, b8, w_leaf), jbuf = _jax_bins_and_sums(jl, live, pose)
    tbuf = cs.slab_scatter_add(
        tl.vals, tl.keys, torch.from_numpy(live), torch.zeros(3),
        torch.tensor(HALF), to_t(pose), FX, FX, spec=spec, depth=DEPTH)
    assert tbuf.shape == jbuf.shape == (spec.total_cells, 4)
    assert (tbuf[:, 0] > 128).sum() > 10          # stacked cells
    diff = np.nonzero((tbuf.numpy() != jbuf).any(-1))[0]
    assert set(diff.tolist()) <= _borderline_cells(keys, vals, n, pose, spec)
    # on the reference's own bins: equal bit for bit, in any leaf order
    bins = cs._Bins(idx=to_t(idx).to(torch.int64), ok=to_t(ok), k=None,
                    z=None, rgba=(to_t(r8), to_t(g8), to_t(b8), None),
                    w_leaf=to_t(w_leaf))
    same = cs._add_sums(bins, spec)
    assert np.array_equal(same.numpy(), jbuf)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(len(keys)))
    shuffled = cs._Bins(idx=bins.idx[perm], ok=bins.ok[perm], k=None, z=None,
                        rgba=tuple(x[perm] for x in bins.rgba[:3]) + (None,),
                        w_leaf=bins.w_leaf[perm])
    assert torch.equal(cs._add_sums(shuffled, spec), same)


@pytest.mark.parametrize("kw", MODES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_render_modes_match(scene, kw):
    jl, tl, *_, pose = scene
    jfb, jw, jz = jcs.render_cone_splat(
        jl, jnp.zeros(3), jnp.float32(HALF), jnp.asarray(pose), FX, FX,
        spec=jcs.make_slab_spec(**SPEC_KW), depth=DEPTH, want_aux=True, **kw)
    tfb, tw, tz = cs.render_cone_splat(
        tl, torch.zeros(3), torch.tensor(HALF), to_t(pose), FX, FX,
        spec=cs.make_slab_spec(**SPEC_KW), depth=DEPTH, want_aux=True, **kw)
    assert tfb.shape == (H, W, 4) and bool(torch.isfinite(tfb).all())
    assert close_share(tfb, jfb, tol=1e-5) >= 0.99
    assert close_share(tw, jw, tol=1e-5) >= 0.99
    assert close_share(tz, jz, tol=1e-5) >= 0.99
    assert float((tfb[..., :3].sum(-1) > 0).float().mean()) > 0.5
    default = cs.render_cone_splat(
        tl, torch.zeros(3), torch.tensor(HALF), to_t(pose), FX, FX,
        spec=cs.make_slab_spec(**SPEC_KW), depth=DEPTH)
    assert not torch.equal(default, tfb)          # the mode took effect


@pytest.mark.parametrize("axis", [0, 1])
def test_double_bilinear_matches(axis):
    img = _fields(3, 15, 20)
    got = cs._double_bilinear(to_t(img), axis).numpy()
    want = np.asarray(jcs._double_bilinear(jnp.asarray(img), axis))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * 255 * 128)


def test_bilinear_upsample_matches():
    img = _fields(4, 15, 20)
    for scale in (1, 2, 4):
        got = cs._upsample(to_t(img), scale, True).numpy()
        want = np.asarray(jcs._upsample(jnp.asarray(img), scale, True))
        assert got.shape == (15 * scale, 20 * scale, 4)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * 255 * 128)
    assert torch.equal(cs._upsample(to_t(img), 2, False),
                       cs._upsample(to_t(img), 2))


@pytest.mark.parametrize("dilate", [0, 1])
def test_bilinear_composite_matches(dilate):
    spec = cs.make_slab_spec(**SPEC_KW)
    jspec = jcs.make_slab_spec(**SPEC_KW)
    fields = {o: _fields(o + 11, H // s, W // s)
              for o, s in zip(spec.offsets, spec.scales)}
    for f in fields.values():
        f *= (np.random.default_rng(6).random(f.shape[:2]) < 0.3)[..., None]
    jfb, jw, jz = jcs._composite_fields(
        lambda o, hh, ww: jnp.asarray(fields[o]), jspec, True, dilate,
        want_aux=True)
    tfb, tw, tz = cs._composite_fields(
        lambda o, hh, ww: to_t(fields[o]), spec, dilate, want_aux=True,
        bilinear=True)
    np.testing.assert_allclose(tfb.numpy(), np.asarray(jfb), atol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


def test_bilinear_composite_of_the_same_words(scene):
    """composite_min_words(bilinear=True) on the reference's own word
    buffer (the multi-device renderers' composite)."""
    jl, _, keys, _, n, pose = scene
    live = (np.arange(len(keys)) < n) & (keys >= 0)
    jspec = jcs.make_slab_spec(**SPEC_KW)
    buf = jcs.slab_scatter_min(
        jl.vals, jl.keys, jnp.asarray(live), jnp.zeros(3), jnp.float32(HALF),
        jnp.asarray(pose), FX, FX, spec=jspec, depth=DEPTH)
    want = np.asarray(jcs.composite_min_words(buf, spec=jspec,
                                              bilinear=True))
    got = cs.composite_min_words(to_t(np.asarray(buf)),
                                 spec=cs.make_slab_spec(**SPEC_KW),
                                 bilinear=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_accumulate_caps_a_stacked_cell():
    """Four saturated leaves in one cell sum to w = 512; the cell counts as
    one march sample (w 128), whose colour adds at (128/127) of its own
    and saturates the ray: the reference's
    TestOracle::test_saturation_caps_accumulation rule."""
    spec = cs.make_slab_spec(**SPEC_KW)
    abuf = torch.zeros((spec.total_cells, 4))
    o, s = spec.offsets[3], spec.scales[3]
    abuf[o] = torch.tensor([512.0, 512.0 * 200, 512.0 * 40, 512.0 * 90])
    field = cs._capped_sum_field(abuf, o, H // s, W // s)
    assert torch.equal(field[0, 0], torch.tensor([128.0, 128.0 * 200,
                                                  128.0 * 40, 128.0 * 90]))
    fb = cs._composite_fields(
        lambda oo, hh, ww: cs._capped_sum_field(abuf, oo, hh, ww), spec, 0)
    np.testing.assert_allclose(fb[0, 0, :3].numpy(),
                               np.array([200, 40, 90]) * 128 / 127 / 255,
                               atol=1e-6)
