"""The program's spans and counters on a cell of slambench: what each layer
of the port costs at the speed it runs, the insert's passes and leaves per
frame, ICP's CUDA graph at work (its captures, replays and eager calls),
the hybrid's band (its stage `step.band`, the spans `band.select` /
`band.march` / `band.merge`, its lanes, trips and live lane-trips, and the
calls whose trips ran as the CUDA kernel or the eager loop beside the
hybrid frames: `band_kernel_calls`, `band_eager_calls`,
`hybrid_frame_count`), the splat (the calls whose z-buffer ran as the CUDA
kernel or the plain version beside the frames rendered with the splat:
`splat_kernel_calls`, `splat_eager_calls`, `splat_frame_count`; and
`splat_atomic_share`, the kernel's rows that issued an atomicMin over its
live rows) and the heal (mirror rebuilds, distance refreshes and stamps), the host's waits on
the card, and what the recorder costs.

    PYTHONPATH=. python examples/span_report.py \
        --workload kinect1cm_splat.orbit --seconds 51 \
        --seeds 2147483711 2147483712 2147483713 --out build/span_report

from the root of a checkout, on a CUDA card (the cell's sizes). For each
seed, in one process:

- `traced`: the cell's traced run as `slambench/run.py --trace 1` makes it
  (slambench.harness.run_cell, the check included: its result line's
  per-layer metrics and `correct`), with the program's spans
  (octree_slam_tpu_torch/utils/spans.py) recording from 10% of the window
  until the profiled frames end. Span and counter means come from the
  whole frames before the profiler starts, so at the program's own speed;
  `idle_outside_step_ms` from the profiled frames, with the spans placed
  on the profiler's clock.
- `off` and `on`: two untraced windows of the cell without the check, the
  spans off and on (from 10% of the window to its end), in turns (the
  order alternates by seed): the median loop period of each, the median
  `app.frame` span, and the frames above the 95th percentile of the
  `app.frame` span against the median frames, by span and by counter.
- `per_span_ns`: the recorder's own cost per span, on and off.

Each run starts with ICP's graph cache empty, as a process of the benchmark
does, and reports `track_calls`: the run's captures, replays and eager
calls of tracking.track_slabs (sensor/tracking.py `CALLS`), beside the
frames it stepped.

`hybrid_share` is the share of `app.frame` spent in `step.heal`,
`step.render` and `step.band`. Where only some frames render a hybrid view
(a traffic's `render_every` > 1), `hybrid_frames` repeats the means over
the frames that do.

Each run prints one JSON line; --out gets them as <out>/<seed>.json."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from octree_slam_tpu_torch.sensor import tracking  # noqa: E402
from octree_slam_tpu_torch.utils import spans  # noqa: E402
from slambench import harness  # noqa: E402
from slambench import stream as stream_mod  # noqa: E402
from slambench import trace as trace_mod  # noqa: E402

SPANS_FROM = 0.1       # share of the window at which the spans start
STAGES = ("step.pyramid", "step.track", "step.heal", "step.fuse",
          "step.render", "step.band", "app.consume")
BAND_SPANS = ("band.select", "band.march", "band.merge")
BAND_COUNTERS = ("band_lanes", "band_trips", "band_live_lane_trips")
# the path a band's trips took: the CUDA kernel or the eager loop
BAND_PATHS = ("band_kernel", "band_eager")
HEAL_COUNTERS = ("mirror_rebuilds", "dist_refreshes", "dist_stamps")
# the path a splat's z-buffer took, and the kernel's live rows and atomics
SPLAT_PATHS = ("splat_kernel", "splat_eager")
SPLAT_COUNTERS = ("splat_live_rows", "splat_atomics")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACK_COUNTERS = tuple(tracking.CALLS)


class SpanLoop(harness._Loop):
    """The harness's loop with the program's spans started at SPANS_FROM
    of the window, and stopped when the profiled frames end (traced) or
    left to the caller (untraced)."""

    def __init__(self, *a, spans_on: bool = True, **k):
        super().__init__(*a, **k)
        self.spans_on = spans_on
        self.spans_started = False
        self.record = None

    def frame_fn(self, i: int):
        now = time.perf_counter()
        if (self.spans_on and not self.spans_started
                and self.t_window is not None
                and now - self.t_window >= SPANS_FROM * self.seconds):
            spans.start()
            self.spans_started = True
        return super().frame_fn(i)

    def _stop_trace(self):
        super()._stop_trace()
        if self.spans_started and self.record is None:
            self.record = spans.stop()


def _mean(d: dict):
    return float(np.mean(list(d.values()))) if d else None


def _union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _measure(iv):
    return sum(b - a for a, b in _union(iv))


def splat_frames(cell, frames) -> set:
    """The frames among `frames` that render the cell's view with the
    splat (run_slam renders frame i where i % render_every == 0)."""
    if cell.render != "splat":
        return set()
    every = int(cell.traffic.get("render_every", 1))
    return {i for i in frames if i % every == 0}


def span_metrics(rec: spans.Record, frames, splat=()) -> dict:
    """Per frame means over `frames` (whole frames of rec); `splat` are
    the frames that rendered the splat view."""
    frames = set(frames)

    def mean_ms(name):
        return _mean({i: v for i, v in rec.frame_ms(name).items()
                      if i in frames})

    def mean_count(name):
        return _mean({i: v for i, v in rec.counter(name).items()
                      if i in frames})
    out = {"frames": len(frames)}
    for name in STAGES + ("app.frame", "fuse.pass", "sync.pager",
                          "sync.heal", "sync.slot", "app.grow",
                          "track.graph") + BAND_SPANS:
        out[name] = mean_ms(name)
    levels = sorted({s.name for s in rec.spans
                     if s.name.startswith("track.level")})
    for name in levels:
        out[name] = mean_ms(name)
    out["track_span_ms"] = out["step.track"]
    out["fuse_span_ms"] = out["step.fuse"]
    out["render_span_ms"] = out["step.render"]
    out["band_span_ms"] = out["step.band"]
    out["consume_span_ms"] = out["app.consume"]
    out["host_wait_ms"] = mean_ms("sync.")
    out["insert_passes_per_frame"] = mean_count("insert_passes")
    out["unique_leaves_per_frame"] = mean_count("unique_leaves")
    out["new_leaves_per_frame"] = mean_count("new_leaves")
    for name in (TRACK_COUNTERS + BAND_COUNTERS + BAND_PATHS + HEAL_COUNTERS
                 + SPLAT_PATHS + SPLAT_COUNTERS):
        out[f"{name}_per_frame"] = mean_count(name)
    for name in BAND_PATHS + SPLAT_PATHS:
        out[f"{name}_calls"] = sum(v for i, v in rec.counter(name).items()
                                   if i in frames)
    out["hybrid_frame_count"] = len(
        {s.frame for s in rec.spans if s.name == "step.band"} & frames)
    lanes, trips, live = (rec.counter(n) for n in BAND_COUNTERS)
    lane_trips = sum(lanes[i] * trips[i] for i in frames)
    out["band_live_share"] = (sum(live[i] for i in frames) / lane_trips
                              if lane_trips else None)
    out["splat_frame_count"] = len(set(splat) & frames)
    rows, atomics = (rec.counter(n) for n in SPLAT_COUNTERS)
    live = sum(rows[i] for i in frames)
    out["splat_atomic_share"] = (sum(atomics[i] for i in frames) / live
                                 if live else None)
    out["stages_ms"] = sum(out[n] or 0.0 for n in STAGES)
    hybrid = sum(out[n] or 0.0 for n in ("step.heal", "step.render",
                                         "step.band"))
    out["hybrid_share"] = (hybrid / out["app.frame"] if out["app.frame"]
                           else None)
    return out


def with_hybrid_frames(rec: spans.Record, frames, cell) -> dict:
    """span_metrics over `frames`, and over those of them that rendered a
    hybrid view where that is some of them but not all."""
    out = span_metrics(rec, frames, splat_frames(cell, frames))
    banded = {s.frame for s in rec.spans if s.name == "step.band"}
    some = [i for i in frames if i in banded]
    if some and len(some) < len(frames):
        out["hybrid_frames"] = span_metrics(rec, some)
    return out


def idle_outside_step(trace: dict, rec: spans.Record) -> dict:
    """Device idle ms per profiled frame while the host is in no step.*
    span: the profiled window (first to last step.pyramid range, as
    slambench/trace.py takes it) less the union of the device's busy
    intervals and the program's step.* spans placed on the profiler's
    clock. Also with the trace's own step.* ranges, the gaps between a
    mapped span's start and its range's (largest, median, and the median
    signed offset), and with the spans moved by that offset."""
    ev = [e for e in trace.get("traceEvents", [])
          if isinstance(e, dict) and e.get("ph") == "X"]
    marks = sorted(float(e["ts"]) for e in ev
                   if e.get("cat") == "user_annotation"
                   and e.get("name") == trace_mod.FRAME_RANGE)
    if len(marks) < 2:
        return {}
    w0, w1 = marks[0], marks[-1]
    n = len(marks) - 1

    def clip(a, b):
        return (max(a, w0), min(b, w1)) if b > w0 and a < w1 else None
    busy = [c for c in (clip(float(e["ts"]), float(e["ts"])
                             + float(e.get("dur", 0.0)))
                        for e in ev if e.get("cat") in _DEVICE_CATS) if c]
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
              for e in ev if e.get("cat") == "user_annotation"
              and e["name"].startswith(trace_mod.STEP_PREFIX)]
    mapped = [(m["ts"], m["ts"] + m["dur"], m["name"])
              for m in rec.chrome_events(int(trace["baseTimeNanoseconds"]))
              if m["name"].startswith(trace_mod.STEP_PREFIX)]
    offsets = []
    for a, b, name in mapped:
        if w0 <= a < w1:
            same = [r for r in ranges if r[2] == name]
            if same:
                r = min(same, key=lambda r: abs(r[0] - a))
                offsets.append(r[0] - a)
    shift = float(np.median(offsets)) if offsets else 0.0

    def idle_with(host, dt=0.0):
        host = [c for c in (clip(a + dt, b + dt) for a, b, _ in host) if c]
        return 1e-3 * ((w1 - w0) - _measure(busy + host)) / n
    gaps = np.abs(offsets) if offsets else np.zeros(1)
    return {"idle_outside_step_ms": idle_with(mapped),
            "idle_outside_step_ms_trace_ranges": idle_with(ranges),
            "idle_outside_step_ms_shifted": idle_with(mapped, shift),
            "device_idle_ms": 1e-3 * ((w1 - w0) - _measure(busy)) / n,
            "profiled_frames": n, "mapped_vs_range_max_us": float(gaps.max()),
            "mapped_vs_range_median_us": float(np.median(gaps)),
            "mapped_offset_median_us": shift}


def _fresh_track_graphs() -> None:
    """ICP's graph cache and call counts as a new process has them."""
    tracking._GRAPHS.clear()
    tracking.reset_calls()


def traced(cell, seed, seconds, dev, log) -> dict:
    """The cell's traced run with the spans on (see the docstring)."""
    box = {}
    summarize = trace_mod.summarize

    def keep(trace, slam, **k):
        box["trace"] = trace
        return summarize(trace, slam, **k)

    def loop(*a, **k):
        box["loop"] = SpanLoop(*a, **k)
        return box["loop"]
    real_loop = harness._Loop
    harness._Loop, trace_mod.summarize = loop, keep
    _fresh_track_graphs()
    try:
        result = harness.run_cell(cell, seed, seconds, True, device=dev,
                                  log=log)
    finally:
        harness._Loop, trace_mod.summarize = real_loop, summarize
    lp = box["loop"]
    rec = lp.record
    # real speed: the whole frames before the profiler, less the last,
    # whose consume ran under it
    before = [i for i in rec.frames if i < lp.prof_first - 1]
    out = {"run": "traced", "seed": seed, "correct": result["correct"],
           "result_metrics": {k: v["value"] for k, v in
                              result["metrics"].items()},
           "device": result["device"], "checks": result["checks"],
           "frames_stepped": (result["attempted"]
                              + int(cell.traffic["warmup_frames"])),
           "track_calls": dict(tracking.CALLS),
           "spans_first_frame": rec.frames[0] if rec.frames else None,
           "profiler_first_frame": lp.prof_first,
           **with_hybrid_frames(rec, before, cell),
           **idle_outside_step(box["trace"], rec)}
    track_host = out["result_metrics"].get("track_host_ms")
    if track_host and out["track_span_ms"]:
        out["track_host_over_span"] = track_host / out["track_span_ms"]
    return out


def window(cell, seed, seconds, dev, spans_on: bool) -> dict:
    """An untraced window of the cell, no check: periods and spans."""
    from octree_slam_tpu_torch import app
    slam = cell.slam
    cfg = harness.slam_config(slam)
    stream = stream_mod.make_stream(cell.traffic, slam, seed, dev,
                                    cell.bench_dir)
    loop = SpanLoop(stream, stream.poses.cpu().numpy(),
                    int(cell.traffic["warmup_frames"]), seconds, None, False,
                    spans_on=spans_on)
    _fresh_track_graphs()
    res = app.run_slam(loop.frame_fn, harness.BIG, cfg,
                       initial_pose=stream.poses[0], gt_fn=loop.gt_fn,
                       render_every=int(cell.traffic.get("render_every", 1)),
                       render_mode=cell.render, stop_fn=loop.stop_fn,
                       device=dev)
    rec = spans.stop() if spans_on else None
    per = harness.periods(loop.marks, loop.t_stop)
    out = {"run": "on" if spans_on else "off", "seed": seed,
           "frames": res.frames - loop.warmup,
           "fps": harness.fps(res.frames - loop.warmup,
                              loop.t_stop - loop.t_window),
           "median_period_ms": 1e3 * float(np.median(per)),
           "frame_ms_p95": harness.p95_ms(per),
           "frames_stepped": res.frames, "track_calls": dict(tracking.CALLS)}
    del res, stream, loop
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    if rec is None:
        return out
    frame_ms = rec.frame_ms("app.frame")
    out["median_frame_span_ms"] = float(np.median(list(frame_ms.values())))
    out["spans_per_frame"] = len([s for s in rec.spans
                                  if s.frame in frame_ms]) / len(frame_ms)
    p95 = float(np.percentile(list(frame_ms.values()), 95.0))
    lo, hi = np.percentile(list(frame_ms.values()), [45.0, 55.0])
    tail = [i for i, v in frame_ms.items() if v > p95]
    mid = [i for i, v in frame_ms.items() if lo <= v <= hi]
    out["frame_span_p95_ms"] = p95
    out["tail"] = with_hybrid_frames(rec, tail, cell)
    out["median_frames"] = with_hybrid_frames(rec, mid, cell)
    out["all_frames"] = with_hybrid_frames(rec, list(frame_ms), cell)
    grows = [(s.frame, (s.t1 - s.t0) * 1e-6) for s in rec.spans
             if s.name == "app.grow"]
    out["grow_frames_ms"] = grows
    out["grow_frames_in_tail"] = sum(f in tail for f, _ in grows)
    out["report"] = rec.report()
    return out


def per_span_ns(n: int = 200_000) -> dict:
    """ns per `with span(...)` on the host: recording (inside a frame), and
    off with no profiler."""
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with spans.span("x"):
            pass
    off = (time.perf_counter_ns() - t0) / n
    spans.start()
    with spans.frame(0):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with spans.span("x"):
                pass
        on = (time.perf_counter_ns() - t0) / n
    spans.stop()
    return {"run": "per_span_ns", "off": off, "on": on}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="kinect1cm_splat.orbit")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", default="build/span_report")
    ap.add_argument("--skip", nargs="*", default=[],
                    choices=("traced", "windows"))
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="the cell cut to slambench/tests/small.py's size, "
                    "on the CPU: checks the script, measures nothing")
    args = ap.parse_args(argv)
    if args.cpu_rehearsal:
        from slambench.tests.small import small_cell
        dev, cell = "cpu", small_cell(args.workload)
    elif not torch.cuda.is_available():
        print("no CUDA device: the spans are read on the card",
              file=sys.stderr)
        return 2
    else:
        dev, cell = "cuda", harness.load_cell(args.workload, ROOT)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    print(json.dumps({"card": harness._device_name(torch.device(dev)),
                      "power_limit_w": harness._power_limit_w(),
                      "torch": torch.__version__,
                      **per_span_ns()}), flush=True)
    for k, seed in enumerate(args.seeds):
        runs = []
        if "traced" not in args.skip:
            runs.append(traced(cell, seed, args.seconds, dev,
                               log=lambda m: print(m, file=sys.stderr)))
            print(json.dumps(runs[-1]), flush=True)
        if "windows" not in args.skip:
            for on in ((False, True) if k % 2 == 0 else (True, False)):
                runs.append(window(cell, seed, args.seconds, dev, on))
                short = {k2: v for k2, v in runs[-1].items()
                         if k2 not in ("report", "tail", "median_frames")}
                if "all_frames" in short:
                    short["all_frames"] = {
                        k2: v for k2, v in short["all_frames"].items()
                        if k2 in ("frames", "app.frame", "hybrid_share",
                                  "band_span_ms", "hybrid_frames",
                                  "render_span_ms", "splat_kernel_calls",
                                  "splat_eager_calls", "splat_frame_count",
                                  "splat_atomic_share")}
                print(json.dumps(short), flush=True)
        (out_dir / f"{seed}.json").write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
