"""Reduction of a torch.profiler trace of consecutive app-loop frames to
what the per-layer readers read (slambench/metrics/<name>.py).

The profiler runs over consecutive loop iterations. The traced window
runs from the start of the first traced frame's first step range
(`FRAME_RANGE`, step.pyramid) to the start of the last one's: whole loop
periods, each from one step's start to the next's. Host time of a range
is the summed duration of the program's `record_function` ranges of that
name: the step's stages (step.pyramid, step.track, step.heal, step.fuse,
step.render, step.band) and the app loop's relocalization attempt
(app.reloc, which runs between two steps). A kernel's device time is
credited to the range its launch was issued in, through the
launch-to-kernel correlation id the profiler records. The device is busy
where any kernel, copy or fill runs.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

FRAME_RANGE = "step.pyramid"
STEP_PREFIX = "step."
OTHER_RANGES = ("app.reloc",)   # credited as the step's ranges are
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class TraceSummary:
    """Per traced window: `frames` loop iterations in `window_s` seconds."""

    frames: int
    window_s: float
    busy_s: float
    range_host_s: Dict[str, float] = field(default_factory=dict)
    range_device_s: Dict[str, float] = field(default_factory=dict)
    # (kernel name, device seconds, batch from the launch grid's z)
    kernels: List[Tuple[str, float, int]] = field(default_factory=list)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    slam: dict = field(default_factory=dict)
    power_limit_w: Optional[float] = None

    def per_frame_ms(self, seconds: float) -> Optional[float]:
        return 1e3 * seconds / self.frames if self.frames else None


def _merge(intervals):
    """Union of [a, b] intervals: sorted disjoint list."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _innermost(events, t):
    """The shortest (name) of the events (ts, end, name) containing t."""
    best = None
    for a, b, name in events:
        if a <= t <= b and (best is None or b - a < best[0]):
            best = (b - a, name)
    return None if best is None else best[1]


def summarize(trace: dict, slam: dict, top: int = 10) -> TraceSummary:
    """Reduce a Chrome-format torch.profiler trace (the parsed JSON)."""
    events = [e for e in trace.get("traceEvents", [])
              if isinstance(e, dict) and e.get("ph") == "X"]
    marks = sorted(float(e["ts"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") == FRAME_RANGE)
    if len(marks) < 2:
        return TraceSummary(frames=0, window_s=0.0, busy_s=0.0, slam=slam)
    w0, w1 = marks[0], marks[-1]
    frames = len(marks) - 1

    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and (e.get("name", "").startswith(STEP_PREFIX)
                         or e.get("name") in OTHER_RANGES)
                    and w0 <= float(e["ts"]) < w1)
    starts = [r[0] for r in ranges]
    host: Dict[str, float] = {}
    for a, b, name in ranges:
        host[name] = host.get(name, 0.0) + (b - a) * 1e-6

    def range_at(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and ranges[i][0] <= t <= ranges[i][1]:
            return ranges[i][2]
        return None

    launch_ts = {}
    for e in events:
        if e.get("cat") in _LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_ts[corr] = float(e["ts"])

    device: Dict[str, float] = {}
    kernels = []
    ops: Dict[str, float] = {}
    busy_iv = []
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        args = e.get("args") or {}
        lt = launch_ts.get(args.get("correlation"))
        issued = lt if lt is not None else a
        if not (w0 <= issued < w1):
            continue
        dur = (b - a) * 1e-6
        name = range_at(issued)
        if name is not None:
            device[name] = device.get(name, 0.0) + dur
        ops[e["name"]] = ops.get(e["name"], 0.0) + dur
        if e.get("cat") == "kernel":
            grid = args.get("grid") or [1, 1, 1]
            kernels.append((e["name"], dur, int(grid[2]) if len(grid) > 2
                            else 1))
        lo, hi = max(a, w0), min(b, w1)
        if hi > lo:
            busy_iv.append((lo, hi))
    busy = _merge(busy_iv)
    busy_s = sum(b - a for a, b in busy) * 1e-6

    # idle gaps inside the window, named by what the host was in
    gaps = []
    t = w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((a - t, t))
        t = max(t, b)
    gaps.sort(reverse=True)
    host_ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                for e in events if e.get("cat") in ("cpu_op",) + _LAUNCH_CATS
                and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"])
                > w0]
    idle = []
    for length, t0 in gaps[:top]:
        mid = t0 + 0.5 * length
        where = range_at(mid) or "app loop"
        op = _innermost(host_ops, mid)
        idle.append((where if op is None else f"{where}: {op}",
                     length * 1e-6))

    return TraceSummary(
        frames=frames, window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
        range_host_s=host, range_device_s=device, kernels=kernels,
        device_ops=sorted(ops.items(), key=lambda kv: -kv[1])[:top],
        idle_gaps=idle, slam=slam)


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
