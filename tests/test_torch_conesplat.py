"""Port parity: the slab cone renderer
(octree_slam_tpu_torch/render/conesplat.py) against the JAX package on one
registry of leaves spread through the view frustum.

Tolerances:
  * `make_slab_spec`: equal (host integer and float math).
  * the slab word buffer: equal except at most 0.2% of its cells, and every
    differing cell must be one that a borderline leaf can reach: a leaf
    whose slab index, pixel or prio, recomputed in float64, lies within
    1e-4 of an integer step (the two libraries' log / exp and XLA's
    reciprocal-multiply for `/ log_r` differ in the last ulp there).
  * `_borrow_empty`, `_composite_fields` (with w_acc, z_first) and
    `_finish` on identical inputs: within 1e-5 of the value's scale (XLA
    contracts the tent and the accumulation into FMAs).
  * `render_cone_splat`: at least 99% of pixels within 1e-4 on every
    channel, all finite; w_acc and z_first likewise."""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import DEVICE, close_share, to_t, words

from octree_slam_tpu.render import conesplat as jcs
from octree_slam_tpu.render.splat import LeafList as JLeafList
from octree_slam_tpu_torch.render import conesplat as cs
from octree_slam_tpu_torch.render.splat import LeafList

DEPTH, W, H, FX = 6, 80, 60, 70.0
HALF = 0.05 * 2 ** (DEPTH - 1)
SPEC_KW = dict(width=W, height=H, fx=FX, leaf_size=0.05, z_near=0.25,
               z_far=10.0, n_slabs=16, max_scale=4)


def _leaves(seed=3, cap=1 << 12):
    """Unique leaf keys of points spread through the view frustum at 0.5
    to 2.4 m (so that they fall into many slabs), with random colours and
    alpha in 126..255, plus dead rows and free slots."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.5, 2.4, 3500)
    cam = np.stack([rng.uniform(-W / 2, W / 2, 3500) / FX * z,
                    rng.uniform(-H / 2, H / 2, 3500) / FX * z, z], -1)
    pose = _pose().astype(np.float64)
    pts = cam @ pose[:3, :3].T + pose[:3, 3]
    q = np.clip(np.floor((pts + HALF) / (2 * HALF / 2 ** DEPTH)), 0,
                2 ** DEPTH - 1).astype(np.int64)
    key = np.zeros(len(q), np.int64)
    for b in range(DEPTH):
        for a in range(3):
            key |= ((q[:, a] >> b) & 1) << (3 * b + a)
    key = np.unique(key).astype(np.int32)
    n = len(key)
    rng.shuffle(key)
    keys = np.full(cap, -1, np.int32)
    keys[:n] = key
    keys[5:n:97] = -1                                   # dead rows
    rgba = rng.integers(0, 256, (cap, 4)).astype(np.uint32)
    rgba[:, 3] = rng.integers(126, 256, cap)            # a few unoccupied
    vals = rgba[:, 0] | rgba[:, 1] << 8 | rgba[:, 2] << 16 | rgba[:, 3] << 24
    return keys, vals.astype(np.uint32), n


def _pose():
    a = 0.3
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                          [-math.sin(a), 0, math.cos(a)]], np.float32)
    T[:3, 3] = (0.11, -0.07, 0.13)
    return T


@pytest.fixture(scope="module")
def scene():
    keys, vals, n = _leaves()
    jl = JLeafList(keys=jnp.asarray(keys), nodes=jnp.zeros_like(keys),
                   vals=jnp.asarray(vals), node2pos=jnp.zeros((8,), jnp.int32),
                   count=jnp.int32(n), overflowed=jnp.bool_(False))
    tl = LeafList(keys=to_t(keys), nodes=torch.zeros(len(keys),
                                                     dtype=torch.int32),
                  vals=to_t(vals), node2pos=torch.zeros(8, dtype=torch.int32),
                  count=torch.tensor(n, dtype=torch.int32),
                  overflowed=torch.tensor(False))
    return jl, tl, keys, vals, n, _pose()


@pytest.mark.parametrize("kw", [
    SPEC_KW,
    dict(width=640, height=480, fx=532.57, leaf_size=0.02),
    dict(width=640, height=480, fx=532.57, leaf_size=0.01, max_scale=4,
         n_slabs=12, z_near=0.3),
    dict(width=322, height=242, fx=300.0, leaf_size=0.08),   # odd halves
])
def test_make_slab_spec_equal(kw):
    j, t = jcs.make_slab_spec(**kw), cs.make_slab_spec(**kw)
    assert tuple(j) == tuple(t) and j.ratio == t.ratio
    assert all(kw["width"] % s == 0 and kw["height"] % s == 0
               for s in t.scales)


def _borderline_cells(keys, vals, n, pose, spec, tol=1e-4):
    """Every cell a leaf can land in if any of its slab index, pixel
    column, pixel row or prio, in float64, is within `tol` of the next
    integer step: the cells where last-ulp differences may show."""
    live = (np.arange(len(keys)) < n) & (keys >= 0)
    k64 = np.where(live, keys, 0).astype(np.int64)
    c = np.zeros((len(keys), 3))
    e = HALF
    for level in range(DEPTH):
        o = (k64 >> (3 * (DEPTH - 1 - level))) & 7
        e *= 0.5
        c += e * np.stack([np.where(o & 1, 1, -1), np.where(o & 2, 1, -1),
                           np.where(o & 4, 1, -1)], -1)
    cam = (c - pose[:3, 3].astype(np.float64)) @ pose[:3, :3].astype(
        np.float64)
    z = cam[:, 2]
    a8 = (vals >> 24).astype(np.float64)
    ok = live & (a8 > 127) & (z > 1e-3) & (z < spec.z_far)
    zs = np.where(ok, z, 1.0)
    px = FX * cam[:, 0] / zs + W / 2.0
    py = H / 2.0 - FX * cam[:, 1] / zs
    log_r = math.log(spec.ratio)
    kr = np.log(np.clip(z, spec.z_near * 1.0001, spec.z_far * 0.9999)
                / spec.z_near) / log_r
    cells = set()
    for i in np.nonzero(ok)[0]:
        cand = []
        for v in (kr[i], px[i], py[i]):
            lo, hi = math.floor(v - tol), math.floor(v + tol)
            cand.append({lo, hi})
        ks = {min(max(k, 0), spec.n_slabs - 1) for k in cand[0]}
        prio_edge = False
        for k in ks:
            z0k = spec.z_near * math.exp(k * log_r)
            sw = max(z0k * (spec.ratio - 1.0), 1e-6)
            pr = min(max((z[i] - z0k) / sw, 0.0), 1.0) * 511.0 \
                + (255 - a8[i]) * (4.0 * spec.z_far / 32766.0) * 512.0 / sw
            prio_edge |= abs(pr - round(pr)) < 1e-2 * max(1.0, pr / 511.0)
        if len(ks) == len(cand[1]) == len(cand[2]) == 1 and not prio_edge:
            continue
        for k, x, y in itertools.product(ks, cand[1], cand[2]):
            if 0 <= x < W and 0 <= y < H:
                s = spec.scales[k]
                cells.add(spec.offsets[k] + (y // s) * (W // s) + x // s)
    return cells


def test_slab_word_buffer(scene):
    jl, tl, keys, vals, n, pose = scene
    spec = cs.make_slab_spec(**SPEC_KW)
    live = (np.arange(len(keys)) < n) & (keys >= 0)
    jbuf = np.asarray(jcs.slab_scatter_min(
        jl.vals, jl.keys, jnp.asarray(live), jnp.zeros(3), jnp.float32(HALF),
        jnp.asarray(pose), FX, FX, spec=jcs.make_slab_spec(**SPEC_KW),
        depth=DEPTH))
    tbuf = cs.slab_scatter_min(
        tl.vals, tl.keys, torch.from_numpy(live), torch.zeros(3),
        torch.tensor(HALF), to_t(pose), FX, FX, spec=spec,
        depth=DEPTH).numpy()
    assert tbuf.shape == jbuf.shape == (spec.total_cells,)
    filled = tbuf != cs.EMPTY
    assert filled.sum() > 500 and len(set(
        np.searchsorted(spec.offsets, np.nonzero(filled)[0], "right"))) >= 3
    diff = np.nonzero(tbuf != jbuf)[0]
    assert len(diff) <= 0.002 * spec.total_cells, len(diff)
    edge = _borderline_cells(keys, vals, n, pose, spec)
    assert set(diff.tolist()) <= edge, sorted(set(diff.tolist()) - edge)


def _fields(seed, hh, ww):
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 129, (hh, ww)).astype(np.float32)
    a[rng.random((hh, ww)) < 0.5] = 0.0
    rgb = rng.integers(0, 256, (hh, ww, 3)).astype(np.float32)
    return np.concatenate([a[..., None], a[..., None] * rgb], -1)


def test_borrow_empty_matches():
    sl = _fields(1, 30, 40)
    got = cs._borrow_empty(to_t(sl)).numpy()
    want = np.asarray(jcs._borrow_empty(jnp.asarray(sl)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[sl[..., 0] > 0] == sl[sl[..., 0] > 0]).all()


@pytest.mark.parametrize("dilate", [0, 1])
def test_composite_fields_matches(dilate):
    spec = cs.make_slab_spec(**SPEC_KW)
    jspec = jcs.make_slab_spec(**SPEC_KW)
    fields = {o: _fields(o + 7, H // s, W // s)
              for o, s in zip(spec.offsets, spec.scales)}
    # thin the fields so that most pixels stay unsaturated for a few slabs
    for f in fields.values():
        f *= (np.random.default_rng(5).random(f.shape[:2]) < 0.3)[..., None]
    jfb, jw, jz = jcs._composite_fields(
        lambda o, hh, ww: jnp.asarray(fields[o]), jspec, False, dilate,
        want_aux=True)
    tfb, tw, tz = cs._composite_fields(
        lambda o, hh, ww: to_t(fields[o]), spec, dilate, want_aux=True)
    np.testing.assert_allclose(tfb.numpy(), np.asarray(jfb), atol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    assert np.isfinite(tz.numpy()).mean() > 0.5
    only = cs._composite_fields(lambda o, hh, ww: to_t(fields[o]), spec,
                                dilate)
    assert torch.equal(only, tfb)


def test_finish_matches():
    rng = np.random.default_rng(2)
    w = rng.uniform(0, 200, (H, W)).astype(np.float32)
    w[rng.random((H, W)) < 0.3] = 0.0
    rgb = (w[..., None] * rng.uniform(0, 255, (H, W, 3))).astype(np.float32)
    got = cs._finish(to_t(w), to_t(rgb), H, W).numpy()
    want = np.asarray(jcs._finish(jnp.asarray(w), jnp.asarray(rgb), H, W))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got[..., 3] == 1.0).all()


def test_render_cone_splat_matches(scene):
    jl, tl, *_, pose = scene
    jfb, jw, jz = jcs.render_cone_splat(
        jl, jnp.zeros(3), jnp.float32(HALF), jnp.asarray(pose), FX, FX,
        spec=jcs.make_slab_spec(**SPEC_KW), depth=DEPTH, want_aux=True)
    tfb, tw, tz = cs.render_cone_splat(
        tl, torch.zeros(3), torch.tensor(HALF), to_t(pose), FX, FX,
        spec=cs.make_slab_spec(**SPEC_KW), depth=DEPTH, want_aux=True)
    assert tfb.shape == (H, W, 4) and bool(torch.isfinite(tfb).all())
    assert close_share(tfb, jfb) >= 0.99
    assert close_share(tw, jw) >= 0.99
    assert close_share(tz, jz) >= 0.99
    assert float((tfb[..., :3].sum(-1) > 0).float().mean()) > 0.5
    plain = cs.render_cone_splat(
        tl, torch.zeros(3), torch.tensor(HALF), to_t(pose), FX, FX,
        spec=cs.make_slab_spec(**SPEC_KW), depth=DEPTH)
    assert torch.equal(plain, tfb)
