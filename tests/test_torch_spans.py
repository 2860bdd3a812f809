"""The port's spans and counters (octree_slam_tpu_torch/utils/spans.py):
off they record nothing and the step opens no profiler range; on, spans
nest with their parents and carry the frame they are charged to (run_slam
consumes a frame one iteration late); mapped onto torch.profiler's clock
they sit on the profiler's own ranges; and over a run_slam of a 160x120,
depth-7 orbit the insert's counters equal what the frames hold: passes,
distinct leaves, first-seen leaves, with the caller's pager too. Device
counters add no operation and no host read until stop().

Tolerances: counts exact; a mapped span within 100 us of its profiler
range."""

import json
import math
import time

import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)

from octree_slam_tpu_torch import SLAMConfig, app, pipeline
from octree_slam_tpu_torch.map import morton
from octree_slam_tpu_torch.sensor import sources
from octree_slam_tpu_torch.utils import spans

# slambench's CPU cut of its cells (160x120, 4 cm, depth 7), with a unique
# cap small enough that every frame pages
CFG = SLAMConfig(width=160, height=120, focal_x=532.57 / 4,
                 focal_y=531.54 / 4, voxel_resolution=0.04, max_depth=7,
                 node_capacity=1 << 16, leaf_capacity=1 << 14,
                 insert_unique_cap=1024)
FRAMES = 7


@pytest.fixture(autouse=True)
def _recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    spans.stop()
    yield
    spans.stop()


@pytest.fixture(scope="module")
def orbit():
    scene = sources.default_scene("cpu")
    poses = [sources.orbit_pose(0.05 * i, radius=2.0, device="cpu")
             for i in range(FRAMES)]
    return [sources.render_frame(scene, p, CFG.focal_x, CFG.focal_y,
                                 width=CFG.width, height=CFG.height)
            for p in poses], poses


class _Tap:
    """pipeline.step wrapped: the registry's count before each step, and
    after it the frame's distinct valid leaf keys (from the state the step
    left: its fused vertex map and pose)."""

    def __init__(self, monkeypatch):
        self.inner = pipeline.step
        self.distinct, self.leaves = [], []
        monkeypatch.setattr(pipeline, "step", self)

    def __call__(self, state, frame, cfg, **kw):
        self.leaves.append(int(state.leaves.count))
        state, out = self.inner(state, frame, cfg, **kw)
        v = state.last_pyramid[cfg.fuse_level].vertex.reshape(-1, 3)
        world = v @ state.pose[:3, :3].T + state.pose[:3, 3]
        keys, valid = morton.encode(world, state.pool.center,
                                    state.pool.half_size, cfg.max_depth)
        self.distinct.append(int(torch.unique(keys[valid]).numel()))
        return state, out


def _run(frames, poses, cfg=CFG, start_at=None, stop_at=None, **kw):
    """run_slam over the orbit; the recorder starts inside frame_fn of
    iteration start_at and stops inside that of stop_at (or after the
    run). Returns (result, record or None)."""
    box = {}

    def frame_fn(i):
        if i == start_at:
            spans.start()
        if i == stop_at:
            box["rec"] = spans.stop()
        return frames[i]

    res = app.run_slam(frame_fn, len(frames), cfg, initial_pose=poses[0],
                       device="cpu", **kw)
    if start_at is not None and "rec" not in box:
        box["rec"] = spans.stop()
    return res, box.get("rec")


def test_off_records_nothing_and_opens_no_range(orbit, monkeypatch):
    """Off with no profiler: one shared no-op object, no record_function
    call in the step or the loop, nothing kept."""
    calls = []
    real = spans.record_function

    def spy(name):
        calls.append(name)
        return real(name)

    monkeypatch.setattr(spans, "record_function", spy)
    assert spans.span("step.track") is spans._NO_SPAN
    assert spans.span("step.fuse") is spans.frame(3)
    frames, poses = orbit
    _run(frames[:3], poses)
    assert calls == []
    rec = spans.stop()
    assert rec.spans == [] and rec.counters == {} and rec.frames == []


def test_nesting_parents_and_the_consume_lag(orbit):
    """Spans nest under their parents and carry their frame; consume of
    frame j runs inside app.frame(j + 1) and carries j; the frame open at
    stop() and the one whose consume did not run are not whole."""
    frames, poses = orbit
    _, rec = _run(frames, poses, start_at=1, stop_at=6)
    # start() inside frame_fn(1) takes effect at frame 2
    assert rec.frames == [2, 3, 4]
    byidx = rec.spans
    for s in byidx:
        parent = byidx[s.parent] if s.parent >= 0 else None
        if s.name == "app.frame":
            assert parent is None
        elif s.name == "app.consume":
            assert parent.name == "app.frame" and parent.frame == s.frame + 1
        elif s.name.startswith("step."):
            assert parent.name == "app.frame" and parent.frame == s.frame
        elif s.name == "track.graph":
            assert parent.name == "step.track"
        elif s.name.startswith("track.level"):
            # eager levels; on a card, the capture's levels run inside
            # track.graph
            assert parent.name in ("step.track", "track.graph")
        elif s.name == "fuse.pass":
            assert parent.name == "step.fuse"
        elif s.name.startswith("band."):
            assert parent.name == "step.band"
        elif s.name == "sync.slot":
            assert parent.name == "app.consume"
        elif s.name == "sync.pager":
            assert parent.name == "step.fuse"
        assert parent is None or parent.t0 <= s.t0 <= s.t1 <= parent.t1
        assert s.frame in (1, 2, 3, 4, 5)
    for i in rec.frames:
        names = [s.name for s in rec.frame_spans(i)]
        assert names.count("app.frame") == names.count("app.consume") == 1
        for stage in ("pyramid", "track", "heal", "fuse", "render"):
            assert names.count(f"step.{stage}") == 1
        # the hybrid's band stage: hybrid frames only
        assert names.count("step.band") == 0
        # the CPU runs ICP's eager loop: its level spans, no graph
        assert {n for n in names if n.startswith("track.level")} == {
            "track.level0", "track.level1", "track.level2"}
        assert "track.graph" not in names
        assert rec.counters[i]["track_eager"] == 1
        assert names.count("sync.slot") == 1
    # consume(1) ran inside app.frame(2): recorded, but frame 1 is not whole
    assert [s.frame for s in rec.spans if s.name == "app.consume"] == [
        1, 2, 3, 4]
    report = rec.report()
    assert report["app.frame"]["count"] == 4     # frames 2-5 closed
    assert report["step.track"]["mean_ms"] > 0.0


def test_chrome_events_sit_on_the_profiler_ranges(tmp_path):
    """Under a CPU torch.profiler each span also opens its range, and the
    span mapped by chrome_events lies within 100 us of it."""
    spans.start()
    x = torch.randn(128, 128)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):
            pass
        for i in range(4):
            with spans.frame(i):
                with spans.span("step.track"):
                    for _ in range(20):
                        x = torch.tanh(x @ x)
                with spans.span("fuse.pass"):
                    time.sleep(0.002)
    rec = spans.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    ranges = [e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"]
    mapped = rec.chrome_events(base)
    assert len(mapped) == 12
    for m in mapped:
        same = [e for e in ranges if e["name"] == m["name"]]
        e = min(same, key=lambda e: abs(float(e["ts"]) - m["ts"]))
        assert abs(float(e["ts"]) - m["ts"]) <= 100.0, (m, e)
        end_gap = (float(e["ts"]) + float(e["dur"])) - (m["ts"] + m["dur"])
        assert abs(end_gap) <= 100.0, (m, e)


@pytest.mark.parametrize("device_remainder", [True, False])
def test_insert_counters_match_the_frames(orbit, monkeypatch,
                                          device_remainder):
    """Per whole frame: insert_passes is 1 plus the pager's pages (the
    frame's distinct leaves over the unique cap, rounded up) and equals
    the pager's reads; unique_leaves is the frame's distinct valid leaf
    keys; new_leaves sum to the registry's growth and never exceed
    unique_leaves. With device_remainder off the caller's pages
    (insert_remainder, inside consume) count for the frame they finish."""
    import dataclasses
    cfg = dataclasses.replace(CFG, device_remainder=device_remainder)
    frames, poses = orbit
    tap = _Tap(monkeypatch)
    final = []
    _, rec = _run(frames, poses, cfg=cfg, start_at=1, state_out=final)
    # stopped after the run: the final drain consumed the last frame
    assert rec.frames == [2, 3, 4, 5, 6]
    passes = rec.counter("insert_passes")
    uniq = rec.counter("unique_leaves")
    new = rec.counter("new_leaves")
    U = cfg.insert_unique_cap
    for i in rec.frames:
        assert uniq[i] == tap.distinct[i] > U
        assert passes[i] == max(1, math.ceil(tap.distinct[i] / U)) >= 2
        pages = [s for s in rec.frame_spans(i) if s.name == "fuse.pass"]
        assert len(pages) == passes[i]
        reads = [s for s in rec.frame_spans(i) if s.name == "sync.pager"]
        assert len(reads) == (passes[i] if device_remainder
                              else passes[i] - 1)
        assert 0 <= new[i] <= uniq[i]
        if not device_remainder:
            in_consume = [s for s in pages
                          if rec.spans[s.parent].name == "app.consume"]
            assert len(in_consume) == passes[i] - 1
    grown = int(final[0].leaves.count) - tap.leaves[2]
    assert sum(new.values()) == grown > 0


def test_device_counters_add_no_op_and_no_host_read(orbit, monkeypatch):
    """The same run with spans on and off: the same aten operations and the
    same item / tolist / Event.synchronize calls; stop() adds one read."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    reads = {"item": 0, "tolist": 0, "synchronize": 0}

    def counting(cls, name):
        real = getattr(cls, name)

        def wrapper(*a, **k):
            reads[name] += 1
            return real(*a, **k)
        monkeypatch.setattr(cls, name, wrapper)

    counting(torch.Tensor, "item")
    counting(torch.Tensor, "tolist")
    counting(torch.cuda.Event, "synchronize")
    frames, poses = orbit
    seen = []
    for on in (False, True, False):
        with Ops() as ops:
            for k in reads:
                reads[k] = 0
            box = {}

            def frame_fn(i):
                if on and i == 1:
                    spans.start()
                return frames[i]

            app.run_slam(frame_fn, 5, CFG, initial_pose=poses[0],
                         device="cpu")
            before = (ops.n, dict(reads))
            box["rec"] = spans.stop()
            after = (ops.n, dict(reads))
        seen.append((before, after, box["rec"]))
    (off, off_after, _), (on_, on_after, rec), again = seen
    assert again[:2] == (off, off_after) and off_after == off
    assert on_ == off
    # stop() reads every device counter in one transfer: a dtype cast a
    # counter at most, one stack, one read
    n_dev = 2 * sum(c["insert_passes"] for c in rec.counters.values())
    assert n_dev >= 2 * len(rec.frames) > 0
    assert 0 < on_after[0] - on_[0] <= 2 * n_dev + 1
    assert on_after[1] == dict(on_[1], tolist=on_[1]["tolist"] + 1)
