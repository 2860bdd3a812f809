"""Spans and counters of the program's layers, read at the speed the
program runs.

`span(name)` brackets a stage (the step's stages, a tracker level, an
insert pass, a host read that waits on the card, a part of the app loop);
`frame(i)` is the root span `app.frame` of one app-loop iteration and sets
the frame id that the spans and counters inside it carry. A span given
`frame=j` carries j, and so do the spans inside it: run_slam's `consume`
handles frame j during iteration j + 1 and is charged to j, the frame
whose vector it reads. `count(name, n)` adds to a host counter of the
current frame; `count_device(name, t)` keeps a reference to a 0-d device
tensor the program computes anyway (no launch, no host read), and
`stop()` reads all of them in one transfer. One counter is not computed
anyway: the hybrid band's live lane-trips (on the card one zeroed
counter and an atomic add a block in the band kernel; in the eager loop
two small launches a trip), which the band adds only while `recording()`.

Off by default, with no option or environment variable. Off, a span is one
shared no-op object when no torch.profiler runs, and `record_function`
(a profiler range) when one does, as the step's ranges always were; nothing
is kept. `start()` turns recording on from the next `frame()`, so a frame
is recorded whole or not at all; `stop()` turns it off and returns the
`Record`. On, a span stamps time.perf_counter_ns() at entry and exit with
its enclosing span as parent, around the profiler's range when a profiler
runs.

Clock: perf_counter_ns. start() and stop() each take an anchor pair
(time.time_ns(), perf_counter_ns()), and Record.chrome_events maps the
spans linearly between the two onto the wall clock in microseconds, which
is the clock of torch.profiler's Chrome trace (its `ts` plus the trace's
baseTimeNanoseconds / 1e3).

The process has one recorder, as it has one profiler: the module-level
functions act on it.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_perf_ns = time.perf_counter_ns


def _profiling() -> bool:
    """A torch.profiler runs (the flag its start and stop set)."""
    return _profiler._is_profiler_enabled


class Span(NamedTuple):
    name: str
    parent: int    # index in Record.spans of the enclosing span, -1: none
    frame: int     # the app-loop frame the span is charged to
    t0: int        # perf_counter_ns at entry
    t1: int        # perf_counter_ns at exit


class _NoSpan:
    """The span while recording is off and no profiler runs."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("rec", "name", "frame", "gen", "idx", "outer_frame", "rf")

    def __init__(self, rec: "Recorder", name: str, frame: Optional[int]):
        self.rec = rec
        self.name = name
        self.frame = frame
        self.gen = rec.gen

    def __enter__(self):
        rec = self.rec
        self.outer_frame = rec.frame_id
        if self.frame is not None:
            rec.frame_id = self.frame
        self.idx = len(rec.open)
        parent = rec.stack[-1] if rec.stack else -1
        rec.open.append([self.name, parent, rec.frame_id, _perf_ns(), 0])
        rec.stack.append(self.idx)
        # the stamps enclose the profiler's range (when one runs), so that
        # what its entry and exit cost is inside the span
        self.rf = record_function(self.name) if _profiling() else None
        if self.rf is not None:
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec = self.rec
        if rec.gen == self.gen:    # else stop() or start() came in between
            rec.open[self.idx][4] = _perf_ns()
            rec.stack.pop()
            rec.frame_id = self.outer_frame
        return False


class Record:
    """What one start() .. stop() recorded: every span, and per frame its
    counters, over the frames recorded whole (`frames`)."""

    def __init__(self, spans: List[Span], counters: Dict[int, Dict[str, int]],
                 anchors: Tuple[Tuple[int, int], Tuple[int, int]]):
        self.spans = spans
        self.counters = counters
        self.anchors = anchors
        closed = {s.frame for s in spans if s.name == "app.frame"}
        consumed = {s.frame for s in spans if s.name == "app.consume"}
        # where the loop consumes its frames (one frame late in run_slam),
        # a frame is whole once its consume ran too
        self.frames = sorted(closed & consumed if consumed else closed)

    def frame_spans(self, i: int) -> List[Span]:
        return [s for s in self.spans if s.frame == i]

    def frame_ms(self, name: str) -> Dict[int, float]:
        """Per whole frame, the summed milliseconds of its spans called
        `name` (or, for a name that ends in ".", of every span whose name
        starts with it); 0.0 where the frame has none."""
        out = dict.fromkeys(self.frames, 0.0)
        prefix = name.endswith(".")
        for s in self.spans:
            if s.frame in out and (s.name.startswith(name) if prefix
                                   else s.name == name):
                out[s.frame] += (s.t1 - s.t0) * 1e-6
        return out

    def counter(self, name: str) -> Dict[int, int]:
        """Per whole frame, the counter's value (0 where nothing counted)."""
        return {i: self.counters.get(i, {}).get(name, 0)
                for i in self.frames}

    def report(self) -> Dict[str, Dict[str, float]]:
        """Per span name (sorted), the mean milliseconds and the count of
        its spans, over every span recorded."""
        total: Dict[str, int] = defaultdict(int)
        count: Dict[str, int] = defaultdict(int)
        for s in self.spans:
            total[s.name] += s.t1 - s.t0
            count[s.name] += 1
        return {k: {"mean_ms": total[k] * 1e-6 / count[k], "count": count[k]}
                for k in sorted(total)}

    def wall_us(self, t_ns: int, base_time_ns: int = 0) -> float:
        """A perf_counter_ns stamp on the wall clock: microseconds after
        base_time_ns (wall-clock nanoseconds)."""
        (w0, p0), (w1, p1) = self.anchors
        scale = (w1 - w0) / (p1 - p0) if p1 > p0 else 1.0
        return ((w0 - base_time_ns) + (t_ns - p0) * scale) * 1e-3

    def chrome_events(self, base_time_ns: int = 0) -> List[dict]:
        """The spans as Chrome-trace complete events on torch.profiler's
        clock: `ts` in microseconds after base_time_ns (the trace's
        baseTimeNanoseconds)."""
        return [{"ph": "X", "cat": "program_span", "name": s.name,
                 "ts": self.wall_us(s.t0, base_time_ns),
                 "dur": (s.t1 - s.t0) * 1e-3, "pid": "program", "tid": 0,
                 "args": {"frame": s.frame, "parent": s.parent}}
                for s in self.spans]


class Recorder:
    """The state behind the module-level functions."""

    def __init__(self, gen: int = 0):
        self.gen = gen
        self.on = False
        self.pending = False
        self.frame_id = -1
        self.open: List[list] = []     # [name, parent, frame, t0, t1]
        self.stack: List[int] = []
        self.counters: Dict[int, Dict[str, int]] = defaultdict(
            lambda: defaultdict(int))
        self.device: List[Tuple[int, str, torch.Tensor]] = []
        self.anchor0 = (0, 0)

    def span(self, name: str, frame: Optional[int] = None):
        if self.on:
            return _Span(self, name, frame)
        return record_function(name) if _profiling() else _NO_SPAN

    def frame(self, i: int):
        if self.pending:
            self.pending = False
            self.on = True
        return self.span("app.frame", frame=i)

    def count(self, name: str, n: int = 1) -> None:
        if self.on:
            self.counters[self.frame_id][name] += n

    def count_device(self, name: str, t: torch.Tensor) -> None:
        if self.on:
            self.device.append((self.frame_id, name, t))

    def start(self) -> None:
        self.__init__(self.gen + 1)
        self.pending = True
        self.anchor0 = (time.time_ns(), _perf_ns())

    def stop(self) -> Record:
        anchor1 = (time.time_ns(), _perf_ns())
        counters = {f: dict(c) for f, c in self.counters.items()}
        by_device: Dict[torch.device, list] = defaultdict(list)
        for f, name, t in self.device:
            by_device[t.device].append((f, name, t))
        for rows in by_device.values():
            values = torch.stack([t.reshape(()).to(torch.int64)
                                  for _, _, t in rows]).tolist()
            for (f, name, _), v in zip(rows, values):
                c = counters.setdefault(f, {})
                c[name] = c.get(name, 0) + v
        # a span still open at stop() belongs to no whole frame
        closed = [k for k, s in enumerate(self.open) if s[4]]
        at = {k: n for n, k in enumerate(closed)}
        spans = [Span(name, at.get(parent, -1), f, t0, t1)
                 for name, parent, f, t0, t1 in (self.open[k]
                                                  for k in closed)]
        rec = Record(spans, counters, (self.anchor0, anchor1))
        self.__init__(self.gen + 1)
        return rec


_RECORDER = Recorder()


def span(name: str, frame: Optional[int] = None):
    """A context manager around one stage: see the module docstring."""
    return _RECORDER.span(name, frame)


def frame(i: int):
    """The root span `app.frame` of app-loop iteration i."""
    return _RECORDER.frame(i)


def count(name: str, n: int = 1) -> None:
    """Add n to the current frame's host counter `name` (when on)."""
    _RECORDER.count(name, n)


def count_device(name: str, t: torch.Tensor) -> None:
    """Add the 0-d device tensor t to the current frame's counter `name`,
    read at stop() (when on)."""
    _RECORDER.count_device(name, t)


def recording() -> bool:
    """The recorder is on: for a counter that costs device work to compute
    (render/hybrid.py's live lane-trips), which is then done only while
    recording."""
    return _RECORDER.on


def start() -> None:
    """Record from the next frame() on; drops whatever was recorded."""
    _RECORDER.start()


def stop() -> Record:
    """Stop recording and return what was recorded."""
    return _RECORDER.stop()
