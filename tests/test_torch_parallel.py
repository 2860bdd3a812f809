"""Port parity for parallel/distributed.py on the 8-device CPU mesh of
tests/conftest.py (the port's mesh puts every shard on the CPU): the shard
bounds, the row-sharded pyramid against the whole frame's, icp_psum, the
Morton-sharded insert shard for shard against the reference's after its
state crossed by convert, and the sharded renders and the model z-buffer
against the reference's on one carried map.

Tolerances: bounds, pyramids (every level, n_px in 1, 2, 4, the halo
clipped at the image's borders, bilateral windows of 1 to 11), pools, registries, unique counts, the
packed z-buffer and the union leaf mirror are bit for bit, and so are the
port's sharded slab words against its global scatter-min; icp_psum's
(A, b) within 1e-5, relative and absolute, of the reference's (the slab
sums add in another order); the splat image within 1e-7 (the reference's
compiled finish scales colours in another order); the slab words equal
the reference's but on at most 0.2% of cells and the cone image within
1e-4 on 99% of pixels (a leaf on a pixel or slab border bins apart in the
two libraries, tests/test_torch_conesplat.py); the hybrid image within
1e-5 on all but 0.5% of pixels (its band selection can flip a tie)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import (DEVICE, close_share, port_config, random_cloud,
                          to_t, words)

from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu.parallel import distributed as jdist
from octree_slam_tpu_torch import convert
from octree_slam_tpu_torch.parallel import distributed
from octree_slam_tpu_torch.sensor import sources, tracking

CFG = SLAMConfig(width=64, height=48, focal_x=60.0, focal_y=60.0,
                 max_depth=6, voxel_resolution=2 * 1.28 / (1 << 6),
                 node_capacity=1 << 16, leaf_capacity=1 << 12,
                 insert_unique_cap=1 << 7, map_split_level=2)
TCFG = port_config(CFG)
# map shards of the carried map: every reference program on it is one
# shard_map compile, whose time grows with the shard count
MAP_SHARDS = 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _look_at(eye, target):
    """world_T_cam of a camera at `eye` looking at `target` (+z forward,
    +y up in the image)."""
    eye, target = np.asarray(eye, np.float32), np.asarray(target, np.float32)
    z = target - eye
    z /= np.linalg.norm(z)
    x = np.cross(np.array([0, 1, 0], np.float32), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = -x, y, z, eye
    return T


def test_bounds_match_reference():
    for level in (1, 2):
        cfg = dataclasses.replace(CFG, map_split_level=level)
        for m in (1, 2, 3, 4, 8):
            np.testing.assert_array_equal(
                distributed.default_bounds(port_config(cfg), m),
                jdist.default_bounds(cfg, m))
    rng = np.random.default_rng(0)
    for m in (2, 4, 8):
        for _ in range(5):
            counts = rng.integers(0, 100, size=64)
            counts[rng.integers(0, 64)] += 5000       # a hot cell
            b = distributed.balanced_bounds(counts, m)
            np.testing.assert_array_equal(b, jdist.balanced_bounds(counts, m))
            assert b[0] == 0 and b[-1] == 64 and np.all(np.diff(b) >= 1)


def _frames(cfg, n=2):
    scene = sources.default_scene(DEVICE)
    return [sources.render_frame(
        scene, sources.orbit_pose(0.3 * i, device=DEVICE), cfg.focal_x,
        cfg.focal_y, width=cfg.width, height=cfg.height) for i in range(n)]


def _noisy(frame, seed):
    """The frame with random depth noise and holes: every window sees
    distinct values, so a missing halo row shows."""
    rng = np.random.default_rng(seed)
    d = frame.depth.numpy().astype(np.int64)
    d = d + rng.integers(-60, 60, d.shape)
    d[rng.random(d.shape) < 0.05] = 0
    return frame._replace(depth=torch.from_numpy(
        np.clip(d, 0, 65535).astype(np.int32)))


def _ramp(frame):
    """The frame's depth replaced by a ramp down the rows: a bilateral
    window that misses rows shifts its mean, so a missing halo row
    shows."""
    y, x = np.mgrid[0:frame.depth.shape[0], 0:frame.depth.shape[1]]
    return frame._replace(depth=torch.from_numpy(
        (1000 + 13 * y + 3 * x).astype(np.int32)))


def _assert_pyramids_equal(a, b, what):
    for lvl, (la, lb) in enumerate(zip(a, b)):
        for name in la._fields:
            x, y = getattr(la, name), getattr(lb, name)
            assert x.shape == y.shape, (what, lvl, name)
            # INF and NaN in the same places, every finite value equal
            np.testing.assert_array_equal(x.numpy(), y.numpy(),
                                          err_msg=f"{what} L{lvl} {name}")


@pytest.mark.parametrize("n_px", [1, 2, 4])
def test_slab_pyramid_equals_whole_frame(n_px):
    """Slab pyramids (48 rows, 3 levels: a 12-row halo, so 4 slabs of 12
    rows all clip it at an image border) gathered equal the pyramid of the
    whole frame, bit for bit, for the orbit frame, a noisy one and a
    ramp."""
    cfg = dataclasses.replace(TCFG, pyramid_depth=3, pyramid_iters=(2, 2, 2))
    mesh = distributed.make_mesh2(n_px, 2, devices=DEVICE)
    slabs = distributed.frame_sharding(mesh, cfg)
    assert [s.rows for s in slabs] == [
        (48 * i // n_px, 48 * (i + 1) // n_px) for i in range(n_px)]
    sensor = distributed.row_sharded_sensor(cfg, mesh)
    f0 = _frames(cfg, 1)[0]
    for i, f in enumerate([f0, _noisy(f0, 3), _ramp(f0)]):
        whole, _ = sensor(f)
        ref = tracking.build_pyramid(f.depth, f.color, cfg)
        _assert_pyramids_equal(whole, ref, f"frame {i} n_px {n_px}")


def test_pyramid_halo_is_derived_and_tight(monkeypatch):
    """12 rows for three levels (10 needed, rounded up to a multiple of
    4), 6 for two, 4 for one; one unit less breaks the equality at a slab
    boundary."""
    for depth, want in ((1, 4), (2, 6), (3, 12)):
        assert distributed.pyramid_halo(
            dataclasses.replace(TCFG, pyramid_depth=depth)) == want
    cfg = dataclasses.replace(TCFG, pyramid_depth=3, pyramid_iters=(2, 2, 2))
    mesh = distributed.make_mesh2(2, 1, devices=DEVICE)
    f = _ramp(_frames(cfg, 1)[0])
    ref = tracking.build_pyramid(f.depth, f.color, cfg)
    monkeypatch.setattr(distributed, "pyramid_halo", lambda cfg: 8)
    whole, _ = distributed.row_sharded_sensor(cfg, mesh)(f)
    with pytest.raises(AssertionError):
        _assert_pyramids_equal(whole, ref, "8-row halo")


def test_slab_pyramid_at_any_window():
    """The halo follows the bilateral's window: at every window size and
    at one and three levels, 4 row slabs of a noisy frame and of a ramp
    give the whole frame's pyramid bit for bit, and one row less of halo
    does not."""
    mesh = distributed.make_mesh2(4, 1, devices=DEVICE)
    f0 = _frames(TCFG, 1)[0]
    for depth in (1, 3):
        for size in (1, 5, 11):
            cfg = dataclasses.replace(TCFG, pyramid_depth=depth,
                                      pyramid_iters=(2,) * depth,
                                      bilateral_kernel_size=size)
            for f in (_noisy(f0, size), _ramp(f0)):
                whole, _ = distributed.row_sharded_sensor(cfg, mesh)(f)
                _assert_pyramids_equal(
                    whole, tracking.build_pyramid(f.depth, f.color, cfg),
                    f"depth {depth} size {size}")
    assert distributed.pyramid_halo(dataclasses.replace(
        TCFG, pyramid_depth=1, bilateral_kernel_size=11)) == 6
    cfg = dataclasses.replace(TCFG, pyramid_depth=1, pyramid_iters=(2,),
                              bilateral_kernel_size=11)
    f = _noisy(f0, 11)
    short = distributed.pyramid_halo(cfg) - 1
    slabs = distributed.frame_sharding(mesh, cfg)
    slab = slabs[0]._replace(padded=(0, slabs[0].rows[1] + short))
    with pytest.raises(AssertionError):
        np.testing.assert_array_equal(
            distributed.slab_pyramid(f, cfg, slab)[0].normal.numpy(),
            tracking.build_pyramid(f.depth, f.color, cfg)[0].normal[
                :slab.rows[1]].numpy())


def test_icp_psum_matches_reference():
    rng = np.random.default_rng(0)
    h, w = 32, 16
    v1 = rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)
    v1[..., 2] = rng.uniform(0.5, 3.0, (h, w))
    v2 = v1 + rng.normal(0, 0.01, (h, w, 3)).astype(np.float32)
    n1 = rng.normal(size=(h, w, 3)).astype(np.float32)
    n1 /= np.linalg.norm(n1, axis=-1, keepdims=True)
    cfg = SLAMConfig()
    A_j, b_j = jdist.icp_psum(*map(jnp.asarray, (v1, n1, v2, n1)), cfg,
                              jdist.make_mesh(8))
    mesh = distributed.make_mesh(8, devices=DEVICE)
    A, b = distributed.icp_psum(*map(to_t, (v1, n1, v2, n1)),
                                port_config(cfg), mesh)
    np.testing.assert_allclose(A.numpy(), np.asarray(A_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_j), rtol=1e-5,
                               atol=1e-5)
    A1, b1, _, _ = tracking.icp_normal_equations(
        *map(to_t, (v1, n1, v2, n1)), port_config(cfg))
    np.testing.assert_allclose(A.numpy(), A1.numpy(), rtol=1e-5, atol=1e-5)


def _assert_maps_equal(tsmap, jsmap, what):
    got = convert.sharded_map_to_numpy(tsmap)
    ref = _np(jsmap)
    for part in ("pool", "leaves"):
        for name, a in got[part].items():
            b = np.asarray(getattr(getattr(ref, part), name))
            np.testing.assert_array_equal(a, b,
                                          err_msg=f"{what} {part}.{name}")
    np.testing.assert_array_equal(got["bounds"], ref.bounds)


@pytest.fixture(scope="module")
def maps():
    """A reference map after one insert (paged: 128 uniques a page), that
    map carried into the port, and both after a second, overlapping
    insert."""
    jmesh = jdist.make_mesh(MAP_SHARDS, axis_name="map")
    mesh = distributed.make_mesh(MAP_SHARDS, axis_name="map", devices=DEVICE)
    p1, c1 = random_cloud(4000, 1, lo=-1.0, hi=1.0)
    p2, c2 = random_cloud(3000, 2, lo=-1.0, hi=1.0)
    insert = jax.jit(lambda s, p, c: jdist.insert_sharded(s, p, c, CFG,
                                                          jmesh))
    jsmap = jdist.make_sharded_map(CFG, jmesh)
    jsmap, _ = insert(jsmap, jnp.asarray(p1), jnp.asarray(c1))
    tsmap = convert.sharded_map_from_numpy(_np(jsmap), TCFG, mesh)
    _assert_maps_equal(tsmap, jsmap, "carried")
    jsmap, jtotal = insert(jsmap, jnp.asarray(p2), jnp.asarray(c2))
    tsmap, ttotal = distributed.insert_sharded(tsmap, to_t(p2), to_t(c2),
                                               TCFG, mesh)
    assert int(ttotal) == int(jtotal) > 2 * CFG.insert_unique_cap
    return jsmap, tsmap, jmesh, mesh


def test_insert_sharded_matches_reference_shard_for_shard(maps):
    jsmap, tsmap, _, _ = maps
    _assert_maps_equal(tsmap, jsmap, "after the insert")
    counts = distributed.shard_leaf_counts(tsmap)
    assert counts.min() > 0
    np.testing.assert_array_equal(counts,
                                  np.asarray(jdist.shard_leaf_counts(jsmap)))


@pytest.mark.parametrize("render", ["splat", "cone", "cone_hybrid",
                                    "model_zbuffer"])
def test_sharded_renders_match_reference(maps, render):
    jsmap, tsmap, jmesh, mesh = maps
    pose = _look_at([0.2, 0.3, 2.2], [0.0, 0.0, 0.0])
    jpose, tpose = jnp.asarray(pose), to_t(pose)
    fx, fy = CFG.focal_x, CFG.focal_y
    if render == "model_zbuffer":
        ref = jax.jit(lambda s, T: jdist.model_zbuffer_sharded(
            s, T, CFG, jmesh))(jsmap, jpose)
        got = distributed.model_zbuffer_sharded(tsmap, tpose, TCFG, mesh)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert (got.numpy() != 0x7FFFFFFF).mean() > 0.1
        return
    fn = {"splat": "render_sharded_map", "cone": "render_sharded_cone",
          "cone_hybrid": "render_sharded_hybrid"}[render]
    ref = np.asarray(jax.jit(lambda s, T: getattr(jdist, fn)(
        s, T, fx, fy, CFG, jmesh))(jsmap, jpose))
    got = getattr(distributed, fn)(tsmap, tpose, fx, fy, TCFG, mesh).numpy()
    assert got.shape == (CFG.height, CFG.width, 4)
    assert got[..., :3].max() > 0.1
    if render == "cone":
        # the scatter-resolve: the per-shard words after the pmin equal the
        # global scatter-min of the union registry bit for bit, and the
        # reference's global scatter-min but for border leaves
        from octree_slam_tpu.render import conesplat as jcs
        from octree_slam_tpu_torch import pipeline
        from octree_slam_tpu_torch.render import conesplat
        spec = pipeline._slab_spec(TCFG)
        tw = distributed.slab_words_sharded(tsmap, tpose, fx, fy, TCFG, spec)
        tk = torch.cat([lv.keys for lv in tsmap.leaves])
        p0 = tsmap.pools[0]
        assert torch.equal(tw, conesplat.slab_scatter_min(
            torch.cat([lv.vals for lv in tsmap.leaves]), tk, tk >= 0,
            p0.center, p0.half_size, tpose, fx, fy, spec=spec,
            depth=TCFG.max_depth))
        jw = jax.jit(lambda s, T: jcs.slab_scatter_min(
            s.leaves.vals.reshape(-1), s.leaves.keys.reshape(-1),
            s.leaves.keys.reshape(-1) >= 0, s.pool.center[0],
            s.pool.half_size[0], T, fx, fy,
            spec=jcs.make_slab_spec(
                width=CFG.width, height=CFG.height, fx=fx,
                leaf_size=CFG.voxel_resolution, z_near=CFG.cone_znear,
                z_far=CFG.max_range, n_slabs=CFG.cone_slabs,
                max_scale=CFG.cone_max_scale),
            depth=CFG.max_depth))(jsmap, jpose)
        # a leaf on a pixel or slab border may bin apart in the two
        # libraries (tests/test_torch_conesplat.py): at most 0.2% of cells
        assert (tw.numpy() != np.asarray(jw)).mean() <= 0.002
        assert close_share(torch.from_numpy(got), ref) >= 0.99
    elif render == "cone_hybrid":
        cache, lvl = distributed.union_leaf_mirror(tsmap, TCFG)
        jcache, jlvl = jax.jit(lambda s: jdist.union_leaf_mirror(
            s, CFG))(jsmap)
        assert lvl == jlvl
        for name in ("values", "occ", "dist"):
            np.testing.assert_array_equal(
                words(getattr(cache, name)) if name == "values"
                else getattr(cache, name).numpy(),
                np.asarray(getattr(jcache, name)), err_msg=name)
        off = (np.abs(got - ref).max(-1) > 1e-5).mean()
        assert off < 0.005, off
    else:
        # the packed words are equal (the model_zbuffer case); the
        # reference's compiled finish scales the colours in another order
        np.testing.assert_allclose(got, ref, atol=1e-7, rtol=0)


def test_sharded_hybrid_ignores_sel_decimate(maps):
    """The reference's render_sharded_hybrid does not pass
    cone_band_sel_decimate on (parallel/distributed.py:684-692): the 2-D
    hybrid with the knob on is the one with it off, bit for bit."""
    _, tsmap, _, mesh = maps
    pose = to_t(_look_at([0.2, 0.3, 2.2], [0.0, 0.0, 0.0]))
    on, off = (distributed.render_sharded_hybrid(
        tsmap, pose, CFG.focal_x, CFG.focal_y,
        dataclasses.replace(TCFG, cone_band_sel_decimate=knob), mesh)
        for knob in (True, False))
    assert torch.equal(on, off)
    assert float(off[..., :3].max()) > 0.1


def test_sharded_insert_union_equals_one_pool():
    """The port's own contract: the union of 8 shards equals one pool fed
    the same points (keys and words), and each shard holds only keys of
    its range."""
    from octree_slam_tpu_torch.map import svo
    from octree_slam_tpu_torch.render import splat
    from octree_slam_tpu_torch.parallel import run2d
    mesh = distributed.make_mesh(8, axis_name="map", devices=DEVICE)
    pts, cols = random_cloud(3000, 9, lo=-1.0, hi=1.0)
    smap = distributed.make_sharded_map(TCFG, mesh)
    half = TCFG.voxel_resolution * 2 ** (TCFG.max_depth - 1)
    pool = svo.create(TCFG.node_capacity, (0.0, 0.0, 0.0), half,
                      device=DEVICE)
    leaves = splat.create_leaf_list(TCFG.leaf_capacity, TCFG.node_capacity,
                                    device=DEVICE)
    for _ in range(2):
        smap, _ = distributed.insert_sharded(smap, to_t(pts), to_t(cols),
                                             TCFG, mesh)
        lk = None
        while True:
            pool, st = svo.insert(pool, to_t(pts), to_t(cols),
                                  depth=TCFG.max_depth,
                                  unique_cap=TCFG.insert_unique_cap,
                                  min_key=lk)
            leaves = splat.append_new_leaves(leaves, st)
            if not bool(st.unique_overflow):
                break
            lk = st.last_key
    k, v = leaves.keys.numpy(), words(leaves.vals)
    live = k >= 0
    o = np.argsort(k[live])
    ku, vu = run2d.union_leaves(smap)
    np.testing.assert_array_equal(ku, k[live][o])
    np.testing.assert_array_equal(vu, v[live][o])
    shift = 3 * (TCFG.max_depth - TCFG.map_split_level)
    for d, lv in enumerate(smap.leaves):
        kd = lv.keys.numpy()
        pref = kd[kd >= 0] >> shift
        assert np.all((pref >= smap.bounds[d]) & (pref < smap.bounds[d + 1]))


def test_mesh_collectives_and_placement():
    mesh = distributed.make_mesh2(2, 4, devices=DEVICE)
    assert mesh.shape == {"px": 2, "map": 4}
    assert distributed.axis_name_of(mesh) == "map"
    assert len(mesh.axis_devices("px")) == 2
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    xs = [torch.tensor([1.0, 5.0]), torch.tensor([3.0, 2.0]),
          torch.tensor([2.0, 9.0])]
    assert all(torch.equal(s, torch.tensor([6.0, 16.0]))
               for s in distributed.psum(xs))
    assert torch.equal(distributed.pmin(xs)[0], torch.tensor([1.0, 2.0]))
    assert torch.equal(distributed.all_gather(xs)[1],
                       torch.tensor([1.0, 5.0, 3.0, 2.0, 2.0, 9.0]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.make_mesh2(1, 2)
