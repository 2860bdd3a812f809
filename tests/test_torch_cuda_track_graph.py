"""ICP's CUDA graph on the card (sensor/tracking.py, `_track_graph`)
against the eager loop it captures, which track_slabs runs for any psum
other than its default: a 640x480 synthetic orbit, a garbage frame that
diverges, a level whose every system is degenerate, a keyframe call
seeded with init_T and the photometric term; the outputs a call returns
survive the next replay; N calls make 1 capture and N - 1 replays and no
replay reads the card; relocalization's candidate score is the same row
on both paths.
Marked `cuda`: without a CUDA device every test skips. The repository's
conftest imports jax, which the card's machine lacks, so run these there
with

    python -m pytest tests/test_torch_cuda_track_graph.py --noconftest -q

Tolerances: none. The replay runs the eager loop's kernels on the same
data, so every output is equal bit for bit (torch.equal)."""

import dataclasses

import pytest
import torch

from octree_slam_tpu_torch import SLAMConfig, relocalize
from octree_slam_tpu_torch.core.types import PyramidLevel
from octree_slam_tpu_torch.sensor import sources, tracking

pytestmark = pytest.mark.cuda

CFG = SLAMConfig()          # 640x480, 3 levels, {10, 5, 4} iterations
STEP = 0.0136               # rad a frame: the benchmark orbit's 0.78 deg


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only there")
    tracking._GRAPHS.clear()
    tracking.reset_calls()
    yield torch.device("cuda", 0)
    tracking._GRAPHS.clear()


def _pyramids(cfg, device, n, step=STEP):
    scene = sources.default_scene(device)
    out = []
    for i in range(n):
        f = sources.render_frame(scene, sources.orbit_pose(
            i * step, radius=2.0, device=device), cfg.focal_x, cfg.focal_y,
            width=cfg.width, height=cfg.height)
        out.append(tracking.build_pyramid(f.depth, f.color, cfg))
    return out


def _eager(last, cur, cfg, init_T=None):
    return tracking.track_slabs(last, [(0, cur)], cfg, init_T=init_T,
                                psum=lambda xs: xs)


def _assert_equal(got, want):
    (gT, gs), (wT, ws) = got, want
    assert torch.equal(gT, wT)
    for name in tracking.TrackStats._fields:
        assert torch.equal(getattr(gs, name), getattr(ws, name)), name


def test_graph_equals_eager_on_an_orbit(device):
    """Frame-to-frame tracking over a short orbit: every call equal to the
    eager loop, 1 capture then replays, and none eager but the controls."""
    pyrs = _pyramids(CFG, device, 5)
    for j in range(1, len(pyrs)):
        got = tracking.track(pyrs[j - 1], pyrs[j], CFG)
        _assert_equal(got, _eager(pyrs[j - 1], pyrs[j], CFG))
        assert not bool(got[1].diverged)
        assert int(got[1].inliers[-1]) > CFG.num_pixels // 2
    assert tracking.CALLS == {"track_graph_captures": 1,
                              "track_graph_replays": len(pyrs) - 2,
                              "track_eager": len(pyrs) - 1}


def test_garbage_frame_diverges_on_both_paths(device):
    pyrs = _pyramids(CFG, device, 1)
    garbage = [PyramidLevel(torch.full_like(lvl.vertex, torch.inf),
                            torch.full_like(lvl.normal, torch.inf),
                            torch.zeros_like(lvl.intensity))
               for lvl in pyrs[0]]
    got = tracking.track(pyrs[0], garbage, CFG)
    _assert_equal(got, _eager(pyrs[0], garbage, CFG))
    assert bool(got[1].diverged)
    assert torch.equal(got[0], torch.eye(4, device=device))


def test_degenerate_systems_freeze_the_seed(device):
    """A pyramid whose every level has no valid pixel (as the CPU test of
    a degenerate level builds it): no update, the seed returned, flagged;
    and a matrix that is not positive definite solves to NaN inside a
    graph as it does eagerly (cholesky_ex's info)."""
    cfg = dataclasses.replace(CFG, width=32, height=24, focal_x=28.0,
                              focal_y=28.0)
    lvls = [PyramidLevel(torch.full((24 >> i, 32 >> i, 3), torch.inf,
                                    device=device),
                         torch.full((24 >> i, 32 >> i, 3), torch.inf,
                                    device=device),
                         torch.zeros(24 >> i, 32 >> i, device=device))
            for i in range(cfg.pyramid_depth)]
    T0 = torch.eye(4, device=device)
    T0[:3, 3] = torch.tensor([0.01, -0.02, 0.03], device=device)
    got = tracking.track(lvls, lvls, cfg, init_T=T0)
    _assert_equal(got, _eager(lvls, lvls, cfg, init_T=T0))
    assert torch.equal(got[0], T0) and bool(got[1].diverged)
    assert int(got[1].inliers.sum()) == 0

    A = -torch.eye(6, device=device)
    b = torch.ones(6, device=device)
    want = tracking.solve_normal_equations(A, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tracking.solve_normal_equations(A, b)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = tracking.solve_normal_equations(A, b)
    g.replay()
    assert torch.isnan(want).all() and torch.equal(out.isnan(), want.isnan())


def test_keyframe_seed_shares_the_graph(device):
    """A keyframe call (init_T: the previous frame's transform against the
    anchor) replays the frame-to-frame call's graph, equal to eager."""
    pyrs = _pyramids(CFG, device, 3)
    T01, _ = tracking.track(pyrs[0], pyrs[1], CFG)
    got = tracking.track(pyrs[0], pyrs[2], CFG, init_T=T01)
    _assert_equal(got, _eager(pyrs[0], pyrs[2], CFG, init_T=T01))
    assert tracking.CALLS["track_graph_captures"] == 1
    assert tracking.CALLS["track_graph_replays"] == 1


def test_photometric_term_in_the_graph(device):
    cfg = dataclasses.replace(CFG, w_rgbd=0.1)
    pyrs = _pyramids(cfg, device, 3)
    for j in (1, 2):
        _assert_equal(tracking.track(pyrs[j - 1], pyrs[j], cfg),
                      _eager(pyrs[j - 1], pyrs[j], cfg))
    assert tracking.CALLS["track_graph_captures"] == 1
    # another key than the same shapes without the term
    tracking.track(pyrs[0], pyrs[1], CFG)
    assert tracking.CALLS["track_graph_captures"] == 2


def test_outputs_survive_the_next_replay(device):
    pyrs = _pyramids(CFG, device, 4)
    first = tracking.track(pyrs[0], pyrs[1], CFG)
    kept = (first[0].clone(), [x.clone() for x in first[1]])
    second = tracking.track(pyrs[2], pyrs[3], CFG)
    third = tracking.track(pyrs[1], pyrs[2], CFG)
    assert torch.equal(first[0], kept[0])
    for x, k in zip(first[1], kept[1]):
        assert torch.equal(x, k)
    for a, b in ((first, second), (second, third), (first, third)):
        assert a[0].data_ptr() != b[0].data_ptr()
    assert not torch.equal(first[0], second[0])


def test_replays_read_nothing_back(device, monkeypatch):
    """After the capture, no replay calls item, tolist,
    Event.synchronize or torch.cuda.synchronize."""
    pyrs = _pyramids(CFG, device, 4)
    tracking.track(pyrs[0], pyrs[1], CFG)
    reads = []

    def counting(owner, name):
        real = getattr(owner, name)

        def wrapper(*a, **k):
            reads.append(name)
            return real(*a, **k)
        monkeypatch.setattr(owner, name, wrapper)

    counting(torch.Tensor, "item")
    counting(torch.Tensor, "tolist")
    counting(torch.cuda.Event, "synchronize")
    counting(torch.cuda, "synchronize")
    for j in (2, 3, 2):
        tracking.track(pyrs[j - 1], pyrs[j], CFG)
    assert reads == []
    assert tracking.CALLS["track_graph_replays"] == 3


def test_relocalization_score_equal_on_both_paths(device, monkeypatch):
    """relocalize._score_pyramid tracks the live pyramid against a model
    pyramid of the same shapes: the same graph, the same packed row as
    the eager loop."""
    pyrs = _pyramids(CFG, device, 3)
    cand = sources.orbit_pose(STEP, radius=2.0, device=device)
    graph = relocalize._score_pyramid(pyrs[0], cand, pyrs[2], CFG)
    assert tracking.CALLS["track_graph_captures"] == 1
    monkeypatch.setattr(tracking, "_graph_eligible", lambda *a: False)
    eager = relocalize._score_pyramid(pyrs[0], cand, pyrs[2], CFG)
    assert tracking.CALLS["track_eager"] == 1
    assert torch.equal(graph, eager)
