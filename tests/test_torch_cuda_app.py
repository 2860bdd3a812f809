"""The app loop on the card against the port itself on the CPU: a small
stream through run_slam that grows, spills and restores; the batched
recovery pyramid of four candidates; a recovery through run_slam with its
launch counts; a checkpoint written on the card and read on the CPU;
the insert's span counters against a pass-by-pass read.
Marked `cuda`: without a CUDA device every test skips. The repository's
conftest imports jax, which the card's machine lacks, so run these there
with

    python -m pytest tests/test_torch_cuda_app.py --noconftest -q

Tolerances: the growth, spill and restore events, capacities, registries
and archives equal; poses within 1e-4; the kernels' outputs bit for bit
against their plain versions on the card; vertex maps card against CPU
within 1e-5 on 99.9% of pixels (the two devices' exp differ in the last
ulp); checkpoint fields word for word."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from octree_slam_tpu_torch import SLAMConfig, app, convert, pipeline
from octree_slam_tpu_torch import relocalize
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