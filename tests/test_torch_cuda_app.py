"""The app loop on the card against the port itself on the CPU: a small
stream through run_slam that grows, spills and restores; the batched
recovery pyramid of four candidates; a recovery through run_slam with its
launch counts; a checkpoint written on the card and read on the CPU;
the insert's span counters against a pass-by-pass read. Then the same
loop at full size, on the benchmark orbit (tests/torch_orbit.py): held to
the orbit's pinned ATE, nodes and leaves, with no more host reads than the
bare step loop's and two; its checkpoint in the reference package's file
and the reference's legacy files; every leaf spilled and restored; a pool
and a registry that double; a recovery from a blanked frame.
Marked `cuda`: without a CUDA device every test skips. The repository's
conftest imports jax, which the card's machine lacks, so run these there
with

    python -m pytest tests/test_torch_cuda_app.py --noconftest -q

Tolerances: the growth, spill and restore events, capacities, registries
and archives equal; poses within 1e-4; the kernels' outputs bit for bit
against their plain versions on the card; vertex maps card against CPU
within 1e-5 on 99.9% of pixels (the two devices' exp differ in the last
ulp); checkpoint fields word for word. At full size: the orbit's pinned
ATE within 1e-7 m and its nodes and leaves exact (the kernels are bit-exact
against their plain versions, so any change in them is a fault); every
checkpoint, tiering and registry word equal; a recovery's last frame within
0.05 m of its ground truth (the reference package's bound)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import torch_orbit as orb
from octree_slam_tpu_torch import SLAMConfig, app, convert, pipeline
from octree_slam_tpu_torch import relocalize
from octree_slam_tpu_torch.map import mips, morton, svo, tiering
from octree_slam_tpu_torch.render.splat import splat_zbuffer
from octree_slam_tpu_torch.sensor import cuda_ops, sources

pytestmark = pytest.mark.cuda

TIER = SLAMConfig(width=80, height=60, focal_x=70.0, focal_y=70.0,
                  pyramid_depth=2, pyramid_iters=(6, 6),
                  voxel_resolution=0.04, max_depth=8,
                  node_capacity=1 << 13, leaf_capacity=1 << 12,
                  extract_capacity=1 << 12, insert_unique_cap=1 << 13,
                  max_march_iters=48, host_spill=True,
                  spill_keep_radius=1.6, restore_radius=1.2)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares the card with the CPU")
    return torch.device("cuda", 0)


def _stream(cfg, n, step=0.02, garbage=None):
    scene = sources.default_scene("cpu")
    gts = [sources.orbit_pose(i * step, radius=2.0, device="cpu")
           for i in range(n)]
    frames = [sources.render_frame(scene, g, cfg.focal_x, cfg.focal_y,
                                   width=cfg.width, height=cfg.height)
              for g in gts]
    if garbage is not None:
        f = frames[garbage]
        frames[garbage] = type(f)(torch.zeros_like(f.depth),
                                  torch.zeros_like(f.color), f.timestamp)
    return frames, gts


def _events(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{") and '"event"' in line]


def _run(cfg, frames, gts, dev, **kw):
    moved = [type(f)(*(x.to(dev) for x in f)) for f in frames]
    sink = []
    res = app.run_slam(lambda i: moved[i], len(frames), cfg,
                       initial_pose=gts[0], gt_fn=lambda i: gts[i],
                       render_every=0, state_out=sink, device=dev, **kw)
    return res, sink[0]


def _registry(state):
    n = int(state.leaves.count)
    keys, order = torch.sort(state.leaves.keys[:n])
    return keys.cpu(), state.leaves.vals[:n][order].cpu()


def test_run_slam_grows_and_tiers_like_cpu(device, capsys):
    frames, gts = _stream(TIER, 8)
    (g, gs, gev), (c, cs, cev) = [
        _run(TIER, frames, gts, dev) + (_events(capsys),)
        for dev in (device, torch.device("cpu"))]
    assert gev == cev and any(e["event"] == "map_spill" for e in gev)
    assert g.spilled_leaves == c.spilled_leaves > 0
    assert g.restored_leaves == c.restored_leaves
    assert (g.final_cfg.node_capacity, g.final_cfg.leaf_capacity) == \
        (c.final_cfg.node_capacity, c.final_cfg.leaf_capacity)
    np.testing.assert_allclose(np.stack(g.poses), np.stack(c.poses),
                               atol=1e-4)
    for a, b in zip(_registry(gs), _registry(cs)):
        assert torch.equal(a, b)
    assert sorted(g.archive.cells) == sorted(c.archive.cells)
    for p, (k, v) in c.archive.cells.items():
        gk, gv = g.archive.cells[p]
        np.testing.assert_array_equal(gk, k)
        np.testing.assert_array_equal(gv, v)


def test_batched_recovery_pyramid_on_card(device):
    """Four candidates' z-buffers at [4, 60, 80] through one bilateral and
    one gated-pyramid launch: the kernels' outputs equal their plain
    versions on the card bit for bit, and the maps the CPU builds from the
    same z-buffers (whose exp differs in the last ulp, flipping a rare 1 mm
    rounding tie) agree on all but a few pixels."""
    cfg = dataclasses.replace(TIER, host_spill=False, node_capacity=1 << 17,
                              leaf_capacity=1 << 15)
    frames, gts = _stream(cfg, 3)
    state = pipeline.init_state(cfg, initial_pose=gts[0], device=device)
    for f in frames:
        state, _ = pipeline.step(state, type(f)(*(x.to(device) for x in f)),
                                 cfg, render="none")
    lv = state.leaves
    live = (torch.arange(lv.keys.shape[0], device=device) < lv.count) \
        & (lv.keys >= 0)
    bufs = torch.stack([splat_zbuffer(
        lv.vals, lv.keys, live, state.pool.center, state.pool.half_size,
        g.to(device), cfg.focal_x, cfg.focal_y, width=cfg.width,
        height=cfg.height, depth=cfg.max_depth, max_range=cfg.max_range)
        for g in gts + gts[:1]])
    assert bufs.shape == (4, cfg.height * cfg.width)
    cuda_ops.reset_launches()
    card = relocalize.pyramid_from_zbuffer(bufs, cfg)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES == {"bilateral7x7": 1, "bilateral_window": 0,
                                 "gated_pyramid5x5": 1}
    assert cuda_ops.LAUNCH_BATCHES["bilateral7x7"] == {4: 1}

    depth = relocalize._depth_from_zbuffer(bufs, cfg)
    gate = 3.0 * cfg.bilateral_sigma_depth
    filt = cuda_ops.bilateral(depth, cfg.bilateral_sigma_spatial,
                              cfg.bilateral_sigma_depth)
    assert torch.equal(filt, cuda_ops.bilateral_plain(
        depth, cfg.bilateral_sigma_spatial, cfg.bilateral_sigma_depth))
    sub = cuda_ops.gated_pyramid(filt, gate, 1)[0]
    assert torch.equal(sub, cuda_ops.gated_pyramid_plain(filt, gate, 1)[0])

    cpu = relocalize.pyramid_from_zbuffer(bufs.cpu(), cfg)
    for lvl, (a, b) in enumerate(zip(card, cpu)):
        assert a.vertex.shape == b.vertex.shape and a.vertex.shape[0] == 4
        va, vb = a.vertex.cpu(), b.vertex
        same = (va == vb) | ((va - vb).abs() <= 1e-5)
        assert float(same.all(-1).float().mean()) >= 0.999, lvl
        assert float(torch.isfinite(vb).all(-1).float().mean()) > 0.2


def test_recovery_through_run_slam_on_card(device, capsys):
    cfg = dataclasses.replace(TIER, host_spill=False, node_capacity=1 << 17,
                              leaf_capacity=1 << 15, keypose_every=2,
                              reloc_candidates=4)
    frames, gts = _stream(cfg, 11, garbage=6)
    cuda_ops.reset_launches()
    g, _ = _run(cfg, frames, gts, device)
    launches = dict(cuda_ops.LAUNCHES)
    gev = [e for e in _events(capsys) if "relocalize" in e["event"]]
    c, _ = _run(cfg, frames, gts, torch.device("cpu"))
    cev = [e for e in _events(capsys) if "relocalize" in e["event"]]
    assert g.relocalizations == c.relocalizations >= 1
    assert [e["frame"] for e in gev] == [e["frame"] for e in cev]
    assert not g.diverged
    # one pyramid a frame and one batched pyramid an attempt, through the
    # 7x7 bilateral
    assert launches.pop("bilateral_window") == 0
    for name, n in launches.items():
        assert n == len(frames) + len(gev), (name, n)
    np.testing.assert_allclose(np.stack(g.poses), np.stack(c.poses),
                               atol=1e-4)


def test_checkpoint_from_card_loads_on_cpu(device, tmp_path):
    cfg = dataclasses.replace(TIER, host_spill=False, insert_dircache=True,
                              saturation_gate=True)
    frames, gts = _stream(cfg, 2)
    state = pipeline.init_state(cfg, initial_pose=gts[0], device=device)
    for f in frames:
        state, _ = pipeline.step(state, type(f)(*(x.to(device) for x in f)),
                                 cfg, render="cone_hybrid")
    path = str(tmp_path / "card.npz")
    app.save_state(path, state, cfg)
    loaded, lcfg = app.load_state(path, cfg, device="cpu")
    assert lcfg == cfg and loaded.pool.child.device.type == "cpu"
    a = app._flatten(convert.state_to_numpy(state))
    b = app._flatten(convert.state_to_numpy(loaded))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_span_counters_match_a_frame_by_frame_read(device, monkeypatch):
    """The insert's device counters on the card, read once at stop(),
    equal a control that reads each pass's n_unique and new_leaf_count as
    the pass ends; and over the same run without the control the recorder
    adds no read of the card (item, tolist, Event.synchronize) until
    stop(), which reads once."""
    from octree_slam_tpu_torch.utils import spans
    cfg = dataclasses.replace(TIER, host_spill=False, node_capacity=1 << 16,
                              leaf_capacity=1 << 14, insert_unique_cap=512)
    frames, gts = _stream(cfg, 6)
    moved = [type(f)(*(x.to(device) for x in f)) for f in frames]
    reads = {"item": 0, "tolist": 0, "synchronize": 0}

    def counting(cls, name):
        real = getattr(cls, name)

        def wrapper(*a, **k):
            reads[name] += 1
            return real(*a, **k)
        monkeypatch.setattr(cls, name, wrapper)

    def run(on: bool):
        for k in reads:
            reads[k] = 0

        def frame_fn(i):
            if on and i == 1:
                spans.start()
            return moved[i]
        app.run_slam(frame_fn, len(moved), cfg, initial_pose=gts[0],
                     render_every=0, device=device)
        before = dict(reads)
        return before, spans.stop(), dict(reads)

    counting(torch.Tensor, "item")
    counting(torch.Tensor, "tolist")
    counting(torch.cuda.Event, "synchronize")
    off, _, _ = run(False)
    on, rec, after = run(True)
    assert on == off and off["synchronize"] == len(moved)
    assert after == dict(on, tolist=on["tolist"] + 1)

    # the control: every pass's counts read back as it ends, by step
    control = []
    fuse_once, step = pipeline._fuse_once, pipeline.step

    def read_pass(*a, **k):
        out = fuse_once(*a, **k)
        st = out[4]
        control[-1].append((int(st.n_unique), int(st.new_leaf_count)))
        return out

    def new_frame(*a, **k):
        control.append([])
        return step(*a, **k)
    monkeypatch.setattr(pipeline, "_fuse_once", read_pass)
    monkeypatch.setattr(pipeline, "step", new_frame)
    _, rec2, _ = run(True)
    assert rec2.frames == rec.frames == [2, 3, 4, 5]
    for i in rec.frames:
        want = control[i]
        for r in (rec, rec2):
            assert r.counters[i]["insert_passes"] == len(want)
            assert r.counters[i]["unique_leaves"] == sum(u for u, _ in want)
            assert r.counters[i]["new_leaves"] == sum(n for _, n in want)
    assert max(len(control[i]) for i in rec.frames) >= 2

# ---------------------------------------------------------------- full size

# the stamps of the reference package's checkpoint file beside `n` and the
# arrays a0 .. a{n-1} (its app.save_state)
REFERENCE_STAMPS = ("node_capacity", "leaf_capacity", "prealloc", "width",
                    "height", "pyramid_depth", "track_finest_level",
                    "fuse_level", "max_depth", "use_dense_mips",
                    "track_keyframe", "insert_dircache", "saturation_gate",
                    "insert_unique_cap", "voxel_resolution")
# arrays cut off the tail of the legacy file (the most a reference file
# with the directory cache may lack: dir_nodes .. stamps_stale)
LEGACY_TAIL_CUT = 6


@pytest.fixture(scope="module")
def orbit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark orbit on the card")
    cfg = orb.bench_config()
    return (cfg, *orb.orbit(cfg))


@pytest.fixture(scope="module")
def orbit_run(orbit):
    return orb.run_slam(*orbit)


def _flat(state):
    return app._flatten(convert.state_to_numpy(state))


def test_run_slam_holds_the_orbit(orbit, orbit_run):
    """The loop a user runs ends with the pinned orbit, and adds only the
    end of run's two reads (the live diverged flag, the last map size) to
    the host reads of the bare step loop."""
    cfg, frames, gts = orbit
    res, state, events, launches, _, reads = orbit_run
    torch.cuda.synchronize()
    with orb.HostReads() as bare:
        st = pipeline.init_state(cfg, initial_pose=gts[0], device="cuda")
        for f in frames:
            st, _ = pipeline.step(st, f, cfg)
        torch.cuda.synchronize()
    assert res.frames == orb.ORBIT_FRAMES and not res.diverged
    assert abs(orb.orbit_ate(res.poses, gts) - orb.ORBIT_ATE_M) \
        <= orb.ORBIT_ATE_TOL_M
    assert res.map_nodes == orb.ORBIT_MAP_NODES
    assert int(state.leaves.count) == orb.ORBIT_MAP_LEAVES
    assert not events
    assert launches == {"bilateral7x7": orb.ORBIT_FRAMES,
                        "bilateral_window": 0,
                        "gated_pyramid5x5": orb.ORBIT_FRAMES}
    assert reads <= bare.count + 2, (reads, bare.count)


def _key_set_off(path, n_arrays, stamps):
    """The keys by which a checkpoint's key set differs from the reference
    package's: `n`, a0 .. a{n_arrays - 1} and `stamps`."""
    with np.load(path) as z:
        keys = set(z.files)
    return sorted(keys ^ {"n", *stamps, *(f"a{i}" for i in range(n_arrays))})


def _rewrite_file(src, dst, drop=(), cut=0, **change):
    """A copy of a checkpoint without the keys `drop` and its last `cut`
    arrays, with `change` written over it: the reference package's legacy
    files. Returns the copy's arrays."""
    with np.load(src) as z:
        data = {k: z[k] for k in z.files if k not in drop}
    n = int(data["n"])
    for i in range(n - cut, n):
        del data[f"a{i}"]
    data["n"] = np.asarray(n - cut)
    data.update(change)
    np.savez(dst, **data)
    return data


def test_checkpoint_of_the_orbit(orbit, orbit_run, tmp_path):
    """save_state writes the reference package's file (n, a0 .. a{n-1},
    the 15 stamps); load_state brings back every word on the card, and one
    more frame from the loaded state and from a copy of the original
    alike. The file without its prealloc stamp is laid out under the
    legacy schedule: accepted, word for word, where that equals this
    build's schedule, else refused."""
    frames = orbit[1]
    res, state, *_ = orbit_run
    cfg = res.final_cfg
    path = str(tmp_path / "state.npz")
    app.save_state(path, state, cfg)
    assert not _key_set_off(path, len(convert.slam_state_leaf_names(cfg)),
                            REFERENCE_STAMPS)
    loaded, lcfg = app.load_state(path, cfg, device="cuda")
    assert lcfg == cfg
    a, b = _flat(state), _flat(loaded)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    s1, o1 = pipeline.step(loaded, frames[-1], lcfg)
    s2, o2 = pipeline.step(convert.clone_state(state), frames[-1], cfg)
    assert torch.equal(o1.pose, o2.pose)
    for x, y in ((s1.pool.value, s2.pool.value),
                 (s1.pool.child, s2.pool.child),
                 (s1.leaves.keys, s2.leaves.keys),
                 (s1.leaves.vals, s2.leaves.vals)):
        assert torch.equal(x, y)
    del loaded, s1, s2

    old = str(tmp_path / "prestamp.npz")
    _rewrite_file(path, old, drop=("prealloc",))
    legacy = svo.prealloc_levels_legacy(cfg.node_capacity)
    if legacy == svo.prealloc_levels(cfg.node_capacity):
        prestamp, _ = app.load_state(old, cfg, device="cuda")
        c = _flat(prestamp)
        for k in a:
            np.testing.assert_array_equal(a[k], c[k], err_msg=k)
    else:
        with pytest.raises(ValueError, match="dense-preallocated"):
            app.load_state(old, cfg, device="cuda")


def test_legacy_tail_of_the_orbit(orbit, tmp_path):
    """The orbit with the directory cache and the saturation gate, saved
    and cut short of its last 6 arrays as the reference's legacy files
    are: the kept arrays load word for word, the directory is reset, the
    saturation mask is rebuilt from the registry and the staleness flags
    are cold. 14 frames saturate no leaf, so half the live registry is set
    to alpha 255 in the file."""
    cfg, frames, gts = orbit
    tcfg = dataclasses.replace(cfg, insert_dircache=True,
                               saturation_gate=True)
    state = pipeline.init_state(tcfg, initial_pose=gts[0], device="cuda")
    for f in frames:
        state, _ = pipeline.step(state, f, tcfg)
    names = convert.slam_state_leaf_names(tcfg)
    own = _flat(state)
    assert np.array_equal(_flat(pipeline.rebuild_sat_mask(state, tcfg))
                          ["sat_mask"], own["sat_mask"])
    assert np.count_nonzero(own["dir_nodes"] >= 0) > 0
    count = int(state.leaves.count)
    vals = own["leaves.vals"].copy()
    vals[:count // 2] |= np.uint32(0xFF000000)
    path, short = str(tmp_path / "state.npz"), str(tmp_path / "tail.npz")
    app.save_state(path, state, tcfg)
    written = _rewrite_file(path, short, cut=LEGACY_TAIL_CUT,
                            **{f"a{names.index('leaves.vals')}": vals})
    got = _flat(app.load_state(short, tcfg, device="cuda")[0])
    reset = ("dir_keys", "dir_nodes", "dir_vals", "dir_pos", "sat_mask")
    for i, k in enumerate(names[:-LEGACY_TAIL_CUT]):
        if k not in reset:
            np.testing.assert_array_equal(got[k], written[f"a{i}"],
                                          err_msg=k)
    assert (got["dir_keys"] == morton.INVALID_KEY).all()
    assert (got["dir_nodes"] == -1).all() and (got["dir_vals"] == 0).all()
    assert (got["dir_pos"] == -1).all()
    # bit (key & 31) of word (key >> 5) of every live key at alpha 255
    keys = own["leaves.keys"][:count]
    sat = keys[(vals[:count] >> 24) == 255]
    want = np.zeros_like(own["sat_mask"])
    np.bitwise_or.at(want, sat >> 5,
                     np.left_shift(np.uint32(1), (sat & 31).astype(np.uint32)))
    assert sat.size > 0 and np.array_equal(got["sat_mask"], want)
    assert not bool(got["mirror_stale"]) and not bool(got["stamps_stale"])


def test_tiering_round_trip_of_the_orbit(orbit_run):
    """Every leaf spilled to host RAM (the camera far away) and restored
    (the camera back): the sorted (key, word) list and the refreshed
    interiors, through the dense mirror, unchanged."""
    res, state, *_ = orbit_run
    cfg = res.final_cfg
    state = convert.clone_state(state)
    lvl = pipeline._accel_level(cfg)

    def sorted_words(keys, vals):
        o = np.argsort(keys, kind="stable")
        return keys[o], vals[o]

    def mirror(pool):
        pool = svo.refresh_interior(pool._replace(value=pool.value.clone()),
                                    depth=cfg.max_depth)
        return mips.rebuild_from_pool(pool, max_depth=cfg.max_depth,
                                      dist_level=lvl).values

    _, keys0, vals0 = tiering._leaf_snapshot(state, cfg)
    before = mirror(state.pool)
    tcfg = dataclasses.replace(cfg, host_spill=True)
    archive = tiering.HostArchive(tcfg.tier_level)
    cam = state.pose[:3, 3].cpu().numpy()
    state, tcfg, n_spilled = tiering.spill_cold(state, tcfg, archive,
                                                camera_pos=cam + 1000.0)
    assert n_spilled == keys0.size and int(state.leaves.count) == 0
    ak = np.concatenate([k for k, _ in archive.cells.values()])
    av = np.concatenate([v for _, v in archive.cells.values()])
    for x, y in zip(sorted_words(ak, av), sorted_words(keys0, vals0)):
        np.testing.assert_array_equal(x, y)
    big = dataclasses.replace(tcfg, restore_radius=1e6)
    state, big, n_restored = tiering.restore_due(state, big, archive,
                                                 camera_pos=cam)
    assert n_restored == keys0.size and len(archive) == 0
    _, keys1, vals1 = tiering._leaf_snapshot(state, big)
    for x, y in zip(sorted_words(keys0, vals0), sorted_words(keys1, vals1)):
        np.testing.assert_array_equal(x, y)
    assert torch.equal(before, mirror(state.pool))


def test_growth_on_the_orbit(orbit, orbit_run):
    """The orbit through run_slam with capacities small enough that the
    3/4 triggers fire: the pool's doubling crosses from 4 to 5 dense
    levels (a rebuild), the registry grows; no overflow, a registry equal
    to an extraction of the pool, and the pinned ATE."""
    cfg, frames, gts = orbit
    keys = orb.sorted_registry(orbit_run[1])[0].numpy()
    depth = cfg.max_depth
    assert orb.pre_nodes(keys, depth,
                         svo.prealloc_levels(cfg.node_capacity)) \
        == orb.ORBIT_MAP_NODES
    n4 = orb.pre_nodes(keys, depth, 4)
    node_cap, leaf_cap = orb.growth_capacities(keys, depth)
    assert svo.prealloc_levels(node_cap) == 4
    assert svo.prealloc_levels(2 * node_cap) == 5
    assert node_cap * 3 // 4 < n4
    gcfg = dataclasses.replace(cfg, node_capacity=node_cap,
                               leaf_capacity=leaf_cap)
    res, state, events, launches, _, _ = orb.run_slam(gcfg, frames, gts)
    grows = [e for e in events if e.get("event") == "map_grow"]
    assert any(e["node_capacity"] == 2 * node_cap for e in grows)
    assert any(e["leaf_capacity"] > leaf_cap for e in grows)
    fc = res.final_cfg
    assert svo.prealloc_levels(fc.node_capacity) == 5
    assert not bool(state.pool.overflowed)
    assert not bool(state.leaves.overflowed)
    pool = state.pool
    if bool(state.interior_stale):
        pool = svo.refresh_interior(pool._replace(value=pool.value.clone()),
                                    depth=depth)
    ex, _ = svo.extract_all_leaves(pool, depth=depth,
                                   start_capacity=fc.leaf_capacity)
    n = int(state.leaves.count)
    assert torch.equal(torch.sort(state.leaves.keys[:n]).values,
                       torch.sort(ex.keys[:int(ex.count)]).values)
    assert not res.diverged
    assert abs(orb.orbit_ate(res.poses, gts) - orb.ORBIT_ATE_M) \
        <= orb.ORBIT_ATE_TOL_M
    for name in orb.KERNELS:
        assert launches[name] == orb.ORBIT_FRAMES, name


def test_recovery_on_the_orbit(orbit):
    """The orbit with one frame blanked (zero depth and colour) recovers
    by relocalization; each attempt is one launch of each kernel over the
    four candidates, in the run and alone."""
    cfg, frames, gts = orbit
    rcfg, frames = orb.recovery(cfg, frames)
    res, state, events, launches, batches, _ = orb.run_slam(rcfg, frames,
                                                            gts)
    attempts = [e for e in events
                if e.get("event") in ("relocalize", "relocalize_failed")]
    assert res.relocalizations >= 1 and len(attempts) >= 1
    assert not res.diverged
    err = np.linalg.norm(res.poses[-1][:3, 3] - gts[-1][:3, 3].cpu().numpy())
    assert err < orb.RELOC_ERR_MAX_M
    for name in orb.KERNELS:
        assert launches[name] == orb.ORBIT_FRAMES + len(attempts), name
        assert batches[name] == {1: orb.ORBIT_FRAMES,
                                 rcfg.reloc_candidates: len(attempts)}, name
    cuda_ops.reset_launches()
    relocalize.relocalize(state, rcfg, res.poses[:orb.RELOC_GARBAGE_FRAME:2])
    for name in orb.KERNELS:
        assert cuda_ops.LAUNCHES[name] == 1, name
