"""The harness on the CPU: discovery by name, the result line, the stream,
the arithmetic, and that no run loads JAX or the JAX package."""

import contextlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from slambench import harness, roofline, stream, trace
from slambench.tests.small import SEED, run_small, small_cell

LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def test_discovery_by_name(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell's
    limits added as files (and BENCHMARK.json entries) are found without
    editing any file the benchmark has."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH_DIR, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "slambench").rglob("*") if p.is_file()}
    bd = tmp_path / "slambench"
    conf = json.loads((bd / "configs" / "kinect1cm_splat.json").read_text())
    conf["slam"]["voxel_resolution"] = 0.02
    (bd / "configs" / "desk2cm_splat.json").write_text(json.dumps(conf))
    traffic = json.loads((bd / "traffic" / "orbit.json").read_text())
    traffic.update(frames_per_loop=240, render_every=30, kind="reversed")
    (bd / "traffic" / "slow_orbit.json").write_text(json.dumps(traffic))
    (bd / "streams").mkdir(exist_ok=True)
    (bd / "streams" / "reversed.py").write_text(textwrap.dedent("""
        from slambench import stream

        def make(traffic, slam, seed, device):
            s = stream.orbit_stream(traffic, slam, seed, device)
            return stream.Stream(*(t.flip(0) for t in s))
    """))
    (bd / "metrics" / "frames_traced.py").write_text(
        "def read(t):\n    return float(t.frames) if t.frames else None\n")
    (bd / "limits" / "desk2cm_splat.slow_orbit.json").write_text(
        json.dumps({"pose_gap": 1e-6, "diverged_differ": 0,
                    "map_diff_share": 1e-3, "render_diff_share": 1e-3}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "desk2cm_splat", "source": "x",
                             "file": "slambench/configs/desk2cm_splat.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "desk2cm_splat.slow_orbit",
                               "config": "desk2cm_splat",
                               "traffic": "slow_orbit", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "frames_traced", "unit": "frames",
                               "better": "higher", "source": "program_span",
                               "layer": "app loop", "moves": "fps",
                               "workloads": ["desk2cm_splat.slow_orbit"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell("desk2cm_splat.slow_orbit", tmp_path)
    assert cell.slam["voxel_resolution"] == 0.02
    assert cell.traffic["frames_per_loop"] == 240
    assert cell.traffic["render_every"] == 30
    tiny = dict(cell.traffic, frames_per_loop=3)
    small = dict(small_cell().slam)
    rev = stream.make_stream(tiny, small, SEED, "cpu", cell.bench_dir)
    fwd = stream.orbit_stream(tiny, small, SEED, "cpu")
    assert torch.equal(rev.poses, fwd.poses.flip(0))
    assert "frames_traced" in [m["name"] for m in cell.per_layer]
    read = harness.load_reader("frames_traced", cell.bench_dir)
    assert read(trace.TraceSummary(frames=8, window_s=1.0, busy_s=0.1)) \
        == 8.0
    old = harness.load_cell("kinect1cm_splat.orbit", tmp_path)
    assert "frames_traced" not in [m["name"] for m in old.per_layer]
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys(traced):
    out = run_small(trace=traced)
    keys = set(out)
    # `checks` carries each number compared beside its limit, last
    assert list(out)[-1] == "checks"
    assert keys == LINE_KEYS | {"recovery", "checks"} | (
        {"breakdown"} if traced else set())
    assert out["recovery"] == {"attempts": 0, "recoveries": 0,
                               "resumed_pose_gap": 0.0, "resumed_differ": 0,
                               "lost_at_close": False, "lost_frames": 0,
                               "resumed_frames": 0}
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == 6
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    cell = small_cell()
    names = {m["name"] for m in (cell.per_layer if traced
                                 else cell.end_to_end)}
    assert set(out["metrics"]) <= names
    if not traced:
        assert set(out["metrics"]) == {"fps", "frame_ms_p95", "setup_s"}
    else:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(out)


@pytest.mark.parametrize("fault", [None, "inverted_view"])
def test_render_every_judges_the_last_rendered_view(fault):
    """With render_every 4 over 6 frames the last view is frame 4's: the
    reference renders its map as it stood then, and an altered view
    still fails."""
    from slambench import faults
    cell = small_cell()
    cell.traffic = dict(cell.traffic, render_every=4)
    with faults.planted(fault) if fault else contextlib.nullcontext():
        out = harness.run_cell(cell, SEED, 1000.0, False, device="cpu",
                               max_frames=6, log=lambda m: None)
    assert out["attempted"] == 6
    assert out["correct"] is (fault is None), out["checks"]
    if fault is None:
        assert all(c["value"] == 0.0 for c in out["checks"].values())


def test_no_card_no_result(tmp_path):
    """run.py without a CUDA device exits non-zero and prints no line."""
    proc = subprocess.run(
        [sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
         "kinect1cm_splat.orbit", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
        timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_stream_same_seed_same_frames():
    cell = small_cell()
    traffic = dict(cell.traffic, frames_per_loop=6)
    a = stream.make_stream(traffic, cell.slam, SEED, "cpu")
    b = stream.make_stream(traffic, cell.slam, SEED, "cpu")
    c = stream.make_stream(traffic, cell.slam, SEED + 1, "cpu")
    assert torch.equal(a.depth, b.depth) and torch.equal(a.color, b.color)
    assert torch.equal(a.poses, b.poses)
    assert not torch.equal(a.depth, c.depth)
    # every seed serves the same loop of poses, from another start
    assert torch.equal(c.poses[:-1], a.poses[1:])
    hit = a.depth > 0
    assert hit.float().mean() > 0.5 and int(a.depth.min()) >= 0


def test_stream_noise_is_the_kinect_model():
    """Depth minus the noiseless depth spreads as sigma(z)."""
    cell = small_cell()
    traffic = dict(cell.traffic, frames_per_loop=4)
    quiet = dict(traffic, depth_noise=None)
    a = stream.make_stream(traffic, cell.slam, SEED, "cpu")
    q = stream.make_stream(quiet, cell.slam, SEED, "cpu")
    hit = q.depth > 0
    z = q.depth[hit].double() / 1000.0
    err = (a.depth[hit] - q.depth[hit]).double() / 1000.0
    sigma = 0.0012 + 0.0019 * (z - 0.4) ** 2
    ratio = float((err / sigma).std())
    assert 0.9 < ratio < 1.1


def test_p95_fps_and_periods():
    marks = [0.0, 0.1, 0.25, 0.3, 0.5]
    per = harness.periods(marks, 0.6)
    assert per == pytest.approx([0.1, 0.15, 0.05, 0.2, 0.1])
    values = list(range(1, 101))
    assert harness.p95_ms([v / 1e3 for v in values]) == pytest.approx(95.05)
    assert harness.fps(300, 30.0) == 10.0


def test_roofline_arithmetic():
    nbytes, ops = roofline.bilateral_work((480, 640), 7)
    assert nbytes == 8 * 480 * 640
    taps = sum(1 for c in range(480) for d in range(-3, 4)
               if 0 <= c + d < 480) * sum(
        1 for c in range(640) for d in range(-3, 4) if 0 <= c + d < 640)
    assert ops == 8 * taps + 2 * 480 * 640
    gb, gops = roofline.gated_pyramid_work((480, 640), 2)
    assert gb == 4 * (480 * 640 + 240 * 320 + 120 * 160)
    assert roofline.bound_s(nbytes, ops) == pytest.approx(
        max(nbytes / 3.35e12, ops / 67e12))
    # the reader: two calls of each kernel at twice their bound read 50%
    from slambench.metrics import stencil_roofline
    slam = small_cell().slam | {"width": 640, "height": 480}
    b1 = roofline.bound_s(*roofline.bilateral_work((1, 480, 640), 7))
    b2 = roofline.bound_s(*roofline.gated_pyramid_work((1, 480, 640), 2))
    t = trace.TraceSummary(frames=2, window_s=1.0, busy_s=0.5, slam=slam,
                           kernels=[("void bilateral_kernel<3>", 2 * b1, 1),
                                    ("gated_pyramid5x5_kernel", 2 * b2, 1),
                                    ("other", 1.0, 1)] * 2)
    assert stencil_roofline.read(t) == pytest.approx(50.0)


def test_trace_reduction():
    """Ranges, credited device time, busy share and idle gaps of a
    hand-made trace of two frames."""
    ev = []

    def x(cat, name, ts, dur, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur, "args": args})

    for f, t0 in enumerate((0.0, 1000.0, 2000.0)):
        x("user_annotation", "step.pyramid", t0, 100)
        x("user_annotation", "step.track", t0 + 100, 500)
        x("cuda_runtime", "cudaLaunchKernel", t0 + 150, 5, correlation=f)
        x("kernel", "k", t0 + 200, 300, correlation=f, grid=[1, 1, 1])
    s = trace.summarize({"traceEvents": ev}, {})
    assert s.frames == 2 and s.window_s == pytest.approx(2e-3)
    assert s.range_host_s["step.track"] == pytest.approx(1e-3)
    assert s.range_device_s["step.track"] == pytest.approx(6e-4)
    assert s.busy_s == pytest.approx(6e-4)
    assert len(s.kernels) == 2
    assert s.idle_gaps[0][1] == pytest.approx(7e-4)
    assert s.idle_gaps[0][0].startswith("app loop")


def test_spread_arithmetic_matches_statistics():
    """The bound's spread: interquartile distance over the median, by
    statistics.quantiles (the benchmark's rule), not numpy's."""
    vals = [10.0, 10.2, 9.9, 10.4, 10.1, 9.8]
    q1, _, q3 = statistics.quantiles(vals, n=4)
    assert (q3 - q1) / statistics.median(vals) == pytest.approx(
        (10.25 - 9.875) / 10.05)
    assert not math.isclose(q3 - q1, float(np.subtract(
        *np.percentile(vals, [75, 25]))))


def test_no_jax_anywhere(tmp_path):
    """A run with every module of JAX and of the JAX package refused at
    import, by whole top-level name: the harness, the reference and the
    program all load and a small CPU run passes."""
    script = textwrap.dedent(f"""
        import importlib.abc, sys
        REFUSE = {{"jax", "jaxlib", "flax", "octree_slam_tpu"}}

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in REFUSE:
                    raise ImportError("refused: " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {str(harness.ROOT)!r})
        from slambench.tests.small import run_small
        import slambench.run, slambench.readings
        out = run_small(frames=3)
        import octree_slam_tpu_torch.app
        from slambench import harness
        assert out["correct"], out["checks"]
        assert not harness.forbidden_modules(), harness.forbidden_modules()
        print("ok", sorted(m for m in sys.modules
                           if m.startswith("octree_slam_tpu_torch"))[:3])
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok ['octree_slam_tpu_torch")


def test_forbidden_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "octree_slam_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert harness.forbidden_modules() == ["jaxlib.xla"]
