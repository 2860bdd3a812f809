"""The benchmark of the PyTorch and CUDA port: one cell, one seed, one run.

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration
(slambench/configs/<name>.json: the SLAMConfig fields and the render) and
a traffic mix (slambench/traffic/<name>.json: the stream's kind and
parameters, and `render_every`); its limits for `correct` are slambench/limits/<cell>.json,
and each per-layer metric is read by slambench/metrics/<metric>.py. All
are found by name, so a later cell or metric is files and entries only.

The run drives the users' loop, octree_slam_tpu_torch.app.run_slam, with
its defaults (auto_grow, relocalization, the signal vector read one frame
late) over a stream made on the device in set-up. A few warm-up frames
run first in the same call; the measured window runs from the first frame
after them to run_slam's return, so the final drain is in it, and it
closes once `seconds` have passed. Each frame_fn call is timestamped: the
time between two calls is one iteration of the loop.

After the window the program's outputs (every frame's pose and divergence
flag, the final map's leaves and words, the last rendered framebuffer)
are held against the plain reference of slambench/reference/, which works
the same frames out again, a tracking loss and its relocalization
attempts included: `check` below.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from importlib import util as importlib_util
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from slambench import stream as stream_mod
from slambench import trace as trace_mod
from slambench.reference import F32, TF32
from slambench.reference import fusion as ref_fusion
from slambench.reference import reloc as ref_reloc
from slambench.reference import render as ref_render
from slambench.reference import sensor as ref_sensor

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "octree_slam_tpu")
TRACED_FRAMES = 8      # consecutive frames under the profiler
TRACE_START = 0.4      # ... from this share of the window on
BIG = 10 ** 9


@dataclass
class Cell:
    name: str
    config: dict          # slambench/configs/<config>.json
    traffic: dict         # slambench/traffic/<traffic>.json
    limits: dict          # slambench/limits/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: Path = BENCH_DIR   # where its metric readers lie

    @property
    def slam(self) -> dict:
        return self.config["slam"]

    @property
    def render(self) -> str:
        return self.config["render"]


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """A per-layer metric is read in the cells it lists, or without a list
    in every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell `workload` of root/BENCHMARK.json with its files, which
    lie under root/slambench/."""
    bench_dir = root / BENCH_DIR.name
    bench = _read_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, workload, names)]
    return Cell(
        name=workload,
        config=_read_json(root / conf["file"]),
        traffic=_read_json(bench_dir / "traffic"
                           / f"{entry['traffic']}.json"),
        limits=_read_json(bench_dir / "limits" / f"{workload}.json"),
        end_to_end=e2e, per_layer=layer, bench_dir=bench_dir)


def load_reader(metric: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """slambench/metrics/<metric>.py's `read`."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib_util.spec_from_file_location(
        f"slambench.metrics.{metric}", path)
    mod = importlib_util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def slam_config(slam: dict):
    """The program's SLAMConfig of a configuration's fields."""
    from octree_slam_tpu_torch.config import SLAMConfig
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in slam.items()}
    return SLAMConfig(**fields)


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


# --- statistics ---------------------------------------------------------

def p95_ms(periods_s: List[float]) -> float:
    """95th percentile (linear between closest ranks) of every period."""
    return float(np.percentile(np.asarray(periods_s, np.float64), 95.0)) \
        * 1e3


def fps(frames: int, window_s: float) -> float:
    return frames / window_s


def periods(marks: List[float], t_close: float) -> List[float]:
    """Loop periods from the frame_fn timestamps of the window's frames
    and the moment the loop asked for the next one (or stopped)."""
    ts = list(marks) + [t_close]
    return [b - a for a, b in zip(ts[:-1], ts[1:])]


# --- the run ------------------------------------------------------------

class _Loop:
    """frame_fn / gt_fn / stop_fn for run_slam, with the window's clock
    and the traced frames."""

    def __init__(self, stream, gts_np, warmup: int, seconds: float,
                 max_frames: Optional[int], trace: bool):
        from octree_slam_tpu_torch.core.types import Frame
        n = len(stream)
        dev = stream.depth.device
        ts = torch.arange(n, dtype=torch.float32, device=dev) / 30.0
        self.frames = [Frame(depth=stream.depth[k], color=stream.color[k],
                             timestamp=ts[k]) for k in range(n)]
        self.gts = gts_np
        self.warmup = warmup
        self.seconds = seconds
        self.max_frames = max_frames
        self.trace = trace
        self.marks: List[float] = []      # frame_fn times from the window
        self.t_window = None
        self.t_stop = None
        self.prof = None
        self.prof_first = None
        self.prof_done = False

    def frame_fn(self, i: int):
        now = time.perf_counter()
        if i == self.warmup:
            self.t_window = now
        if i >= self.warmup:
            self.marks.append(now)
            if self.trace:
                self._trace_tick(i, now)
        return self.frames[i % len(self.frames)]

    def gt_fn(self, i: int):
        return self.gts[i % len(self.gts)]

    def stop_fn(self, i: int) -> bool:
        if i <= self.warmup:
            return False
        now = time.perf_counter()
        done = now - self.t_window >= self.seconds or (
            self.max_frames is not None and i - self.warmup >= self.max_frames)
        if done:
            self.t_stop = now
            if self.prof is not None and not self.prof_done:
                self._stop_trace()
        return done

    # the traced frames: the profiler runs from the frame_fn call of the
    # first one to the frame_fn call after the one that closes the last
    # period (trace.py reads the periods from step start to step start)
    def _trace_tick(self, i: int, now: float):
        if self.prof_done:
            return
        if self.prof is None:
            if now - self.t_window >= TRACE_START * self.seconds or (
                    self.max_frames is not None
                    and i - self.warmup >= self.max_frames // 3):
                acts = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                self.prof = torch.profiler.profile(activities=acts)
                self.prof.__enter__()
                self.prof_first = i
            return
        if i - self.prof_first > TRACED_FRAMES:
            self._stop_trace()

    def _stop_trace(self):
        self.prof.__exit__(None, None, None)
        self.prof_done = True


class _StepTap:
    """Keeps, for each step the loop runs, its diverged and overflow flags
    (0-d device tensors, no copy), and the framebuffer of the last step
    that rendered with its frame index."""

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self.inner = pipeline.step
        self.flags: List = []
        self.framebuffer = None
        self.fb_frame = None

    def __call__(self, state, frame, cfg, render="splat", **kw):
        state, out = self.inner(state, frame, cfg, render=render, **kw)
        if render != "none":
            self.framebuffer = out.framebuffer
            self.fb_frame = len(self.flags)
        self.flags.append((out.diverged, out.map_overflowed))
        return state, out

    def __enter__(self):
        self.pipeline.step = self
        return self

    def __exit__(self, *exc):
        self.pipeline.step = self.inner


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _power_limit_w() -> Optional[float]:
    """The card's power limit from nvidia-smi, None where it cannot say."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             max_frames: Optional[int] = None, control: bool = False,
             log=print) -> dict:
    """One run of `cell`: set-up, the window, the check. Returns the result
    line's object (with the control's readings under "control" when
    `control`, for slambench/readings.py)."""
    from octree_slam_tpu_torch import app, pipeline

    t0 = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    slam = cell.slam
    ref_sensor.check_config(slam)
    ref_render.check_config(slam, cell.render)
    ref_reloc.check_config(slam)
    cfg = slam_config(slam)
    seed = int(seed) % (1 << 63)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_dev = time.perf_counter()

    stream = stream_mod.make_stream(cell.traffic, slam, seed, dev,
                                    cell.bench_dir)
    gts_np = stream.poses.cpu().numpy()
    stream_bytes = sum(t.numel() * t.element_size() for t in stream)
    t_stream = time.perf_counter()
    warmup = int(cell.traffic["warmup_frames"])
    render_every = int(cell.traffic.get("render_every", 1))
    loop = _Loop(stream, gts_np, warmup, seconds, max_frames, trace)
    state_out: list = []
    with _StepTap(pipeline) as tap:
        res = app.run_slam(
            loop.frame_fn, BIG, cfg, initial_pose=stream.poses[0],
            gt_fn=loop.gt_fn, render_every=render_every,
            render_mode=cell.render,
            state_out=state_out, stop_fn=loop.stop_fn, device=dev)
    t_end = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    mem_peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)

    n_run = res.frames
    n_win = n_run - warmup
    window_s = t_end - loop.t_window
    flags = torch.stack([torch.stack([a, b]) for a, b in tap.flags]).cpu() \
        .numpy().astype(bool)
    diverged, overflowed = flags[:, 0], flags[:, 1]

    # the program's outputs, then its state is freed before the reference
    final = state_out.pop()
    cnt = final_leaves = int(final.leaves.count)
    nodes = final.leaves.nodes[:cnt].to(torch.int64)
    prog = dict(poses=np.stack(res.poses).astype(np.float32),
                keys=final.leaves.keys[:cnt].clone(),
                words=final.pool.value[nodes].clone(),
                framebuffer=tap.framebuffer.clone(), fb_frame=tap.fb_frame,
                diverged=diverged)
    del final, tap, res
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    summary = None
    if trace and loop.prof is not None:
        summary = _summarize_trace(loop.prof, slam)
        loop.prof = None

    t_check = time.perf_counter()
    checks, ctrl, redo = check(cell, stream, prog, n_run, dev,
                               control=control)
    t_check = time.perf_counter() - t_check
    correct = all(v <= lim for v, lim in checks.values())
    # failed: a frame whose map overflowed, or that the program held lost
    # where the reference's redo had resumed tracking; a loss still open
    # on both sides when the window closes is no failure
    failed = int((overflowed[warmup:]
                  | (diverged[warmup:] & ~redo["flags"][warmup:])).sum())

    out = {"correct": correct, "attempted": n_win, "failed": failed}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            read = load_reader(m["name"], cell.bench_dir)
            v = None if summary is None else read(summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
    else:
        values = {"fps": fps(n_win, window_s),
                  "frame_ms_p95": p95_ms(periods(loop.marks, loop.t_stop)),
                  "setup_s": loop.t_window - t0}
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": _device_name(dev),
                "count": 1, "memory_peak_bytes": int(mem_peak)}
    if trace:
        dev_info["busy_s"] = 0.0 if summary is None else summary.busy_s
        dev_info["window_s"] = 0.0 if summary is None else summary.window_s
        if summary is not None and summary.power_limit_w is not None:
            dev_info["power_limit_w"] = summary.power_limit_w
        out["device"] = dev_info
        if summary is not None:
            out["breakdown"] = {
                "device_ops": [[n[:200], s] for n, s in summary.device_ops],
                "idle_gaps": [[n, s] for n, s in summary.idle_gaps]}
    else:
        out["device"] = dev_info
    out["recovery"] = {k: redo[k] for k in (
        "attempts", "recoveries", "resumed_pose_gap", "resumed_differ",
        "lost_at_close")}
    out["recovery"].update(lost_frames=int(redo["flags"][warmup:].sum()),
                           resumed_frames=len(redo["resumed"]))
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    if control:
        out["control"] = ctrl
    per = periods(loop.marks, loop.t_stop)
    half = len(per) // 2
    log(f"[slambench] {cell.name} seed {seed}: {n_win} frames in "
        f"{window_s:.3f} s after {warmup} warm-up frames; median period "
        f"{1e3 * float(np.median(per)):.2f} ms (first half "
        f"{1e3 * float(np.median(per[:half] or per)):.2f}, second "
        f"{1e3 * float(np.median(per[half:])):.2f}); "
        f"{int(final_leaves)} leaves"
        + ("" if summary is None else
           f"; traced {summary.frames} frames in {summary.window_s:.3f} s")
        + f"; set-up: {t_dev - t0:.3f} s to the device, stream "
        f"{t_stream - t_dev:.3f} s, warm-up {loop.t_window - t_stream:.3f} s"
        f"; memory peak {mem_peak} B, of it the stream {stream_bytes} B"
        f"; losses: {out['recovery']['lost_frames']} frames of the window "
        f"held lost by the reference, {redo['attempts']} relocalization "
        f"attempts redone, {redo['recoveries']} recoveries, resumed at "
        f"frames {redo['resumed'][:8]}"
        f"{'...' if len(redo['resumed']) > 8 else ''}"
        f"; check {t_check:.3f} s")
    return out


def _summarize_trace(prof, slam: dict) -> trace_mod.TraceSummary:
    """Export the profiler's trace under TMPDIR, reduce it, delete it."""
    fd, path = tempfile.mkstemp(prefix="slambench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        summary = trace_mod.summarize(trace_mod.load(path), slam)
    finally:
        os.unlink(path)
    if torch.cuda.is_available():
        summary.power_limit_w = _power_limit_w()
    return summary


# --- correct -------------------------------------------------------------

def _pose_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest entry gap of the [R | t] blocks (t in metres)."""
    return float((a[:3, :4] - b[:3, :4]).abs().max())


def _map_diff(keys: torch.Tensor, words: torch.Tensor,
              table: ref_fusion.MapTable, n_ref: int) -> int:
    """Leaves of the program's map that the reference lacks, holds with
    another word, or that the program lists twice, plus the reference's
    leaves the program lacks."""
    n_cells = table.words.shape[0]
    k = keys.to(torch.int64)
    inside = (k >= 0) & (k < n_cells)
    ref_at = torch.where(inside, table.words[torch.clamp(k, 0, n_cells - 1)],
                         ref_fusion.EMPTY_VALUE)
    wrong = int(((ref_at != words) | ~inside).sum())
    uk = torch.unique(k[inside])
    dups = int(inside.sum()) - uk.shape[0]
    present = int((table.words[uk] != ref_fusion.EMPTY_VALUE).sum())
    return wrong + dups + (n_ref - present)


def _render_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """Share of pixels whose RGBA differs by more than one 8-bit level in
    some channel."""
    return float(((a - b).abs() > 1.0 / 255.0).any(dim=-1)
                 .to(torch.float64).mean())


def _render(render: str, table, pose, slam: dict, ar):
    """The reference's view of `table` from `pose`. The hybrid stamps the
    free cells of the table it renders, so it renders a copy."""
    keys, words = table.leaves()
    table = copy.copy(table)
    table.words = table.words.clone()
    return ref_render.view(render, table, keys, words, pose, slam, ar)


class _Redo:
    """One side of the check, the reference (float32) or the control
    (TF32): its own map table and its redo of the app loop's lost state,
    keyposes and relocalization attempts, frame by frame. The poses it
    composes its solves with and fuses by are the program's."""

    def __init__(self, slam: dict, ar, dev):
        self.slam = slam
        self.ar = ar
        self.table = ref_fusion.MapTable(slam, dev)
        self.lost = False         # the live state's sticky flag
        self.flags: List[bool] = []   # each frame's flag as its step left it
        self.keyposes: List[int] = []  # frames whose poses are keyposes
        self.models: Dict[int, list] = {}  # a candidate frame's model pyramid
        self.recovered = None     # the pose the next solve starts from
        self.attempts = 0
        self.recoveries = 0

    def step(self, j: int, prev, pyr, poses, color) -> Optional[torch.Tensor]:
        """Frame j's step: its solve against frame j-1, its flag, its fuse.
        Returns its pose, None where the frame is held lost (or is the
        first, which keeps the pose the run was given)."""
        pose = None
        flag = self.lost        # sticky: a lost frame's solve decides nothing
        if j > 0 and not flag:
            T, div = ref_sensor.track(prev, pyr, self.slam, self.ar)
            flag = bool(div)
            if not flag:
                base = (self.recovered if self.flags[j - 1]
                        else poses[j - 1])
                pose = self.ar.mm(base, T)
        self.recovered = None
        self.lost = flag
        self.flags.append(flag)
        if not flag:
            self.table.fuse(self.table.world_points(pyr[0][0], poses[j],
                                                    self.ar), color)
            self.models.clear()
        return pose

    def consume(self, i: int, live, poses) -> None:
        """The loop's handling of frame i one frame late, with `live` the
        pyramid of the last frame stepped: an attempt while the live state
        is lost, a keypose where frame i tracked."""
        k = int(self.slam["reloc_candidates"])
        if self.flags[i]:
            if self.lost:
                self.attempts += 1
                cands = ref_reloc.candidates(self.keyposes, i, k)
                self.models = {c: self.models.get(c) for c in cands}
                for c in cands:
                    if self.models[c] is None:
                        self.models[c] = ref_reloc.model(
                            self.table, poses[c], self.slam, self.ar)
                anchors = [(poses[c], self.models[c]) for c in cands]
                pose = ref_reloc.attempt(anchors, live, self.slam, self.ar)
                if pose is not None:
                    self.lost = False
                    self.recovered = pose
                    self.recoveries += 1
        elif i % int(self.slam["keypose_every"]) == 0:
            self.keyposes.append(i)
            del self.keyposes[:-k]


def check(cell: Cell, stream, prog: dict, n_run: int, dev,
          control: bool = False):
    """The reference's judgement of the program's outputs. Returns
    ({number: (value, limit)}, the control's numbers or None, the redo's
    account of losses: `flags` the reference's lost flag of every frame,
    `attempts`, `recoveries`, `resumed` the first frame tracked after each
    recovery, `resumed_pose_gap` and `resumed_differ` the two numbers
    below over those frames and the frames on which the program resumed,
    `lost_at_close` whether a loss is still open after the final drain).

    The reference follows the program frame by frame, with the app loop's
    one-frame lag: it redoes every frame's pyramid and ICP solve from the
    frame's depth and the previous frame's, holds a frame lost where its
    solve diverged or the live state already was, and fuses the frames it
    holds tracking with the program's pose into its own table. After frame
    j+1's step it handles frame j: while the live state is lost it redoes
    the relocalization attempt (reference/reloc.py) against its table as
    it stands, tracking frame j+1's pyramid (an attempt in the final drain
    tracks the last frame's), until one succeeds; where frame j tracked
    and j % keypose_every == 0, the program's pose of j is a keypose. The
    first frame tracked after a recovery composes its solve with the
    reference's recovered pose.

    pose_gap: the largest [R | t] entry gap between the program's pose and
      the reference's solve composed with the program's previous pose (the
      reference's recovered pose on the first frame after a recovery),
      over every frame the reference holds tracking; the first frame's
      against the pose the run was given.
    diverged_differ: frames whose lost flag differs from the one the
      reference's redo gives, the frame where tracking resumes included.
    map_diff_share: leaves that differ in key or word between the
      program's final map and the reference's, over the reference's count.
    render_diff_share: the reference renders its map as it stood at the
      last frame the program rendered, in the cell's mode, from its own
      pose of that frame (the program's where it holds the frame lost);
      the share of pixels that differ from the program's view by more than
      an 8-bit level.
    The control is the reference computed in TF32 in the program's place,
    judged by the same numbers against the reference."""
    slam = cell.slam
    limits = cell.limits
    n = len(stream)
    poses = torch.from_numpy(prog["poses"]).to(dev)
    diverged = prog["diverged"]
    fb_frame = prog["fb_frame"]
    sides = {"ref": _Redo(slam, F32, dev)}
    if control:
        sides["ctrl"] = _Redo(slam, TF32, dev)
    ref = sides["ref"]
    # the start: the first frame keeps the pose the run was given
    gaps = {"ref": _pose_gap(poses[0], stream.poses[0]), "ctrl": 0.0}
    resumed, resumed_gap = [], 0.0
    views: Dict[str, torch.Tensor] = {}
    prev = None
    for j in range(n_run):
        k = j % n
        pyr = ref_sensor.pyramid(stream.depth[k], slam)
        got = {name: side.step(j, prev, pyr, poses, stream.color[k])
               for name, side in sides.items()}
        if got["ref"] is not None:
            gap = _pose_gap(poses[j], got["ref"])
            gaps["ref"] = max(gaps["ref"], gap)
            if ref.flags[j - 1]:
                resumed.append(j)
                resumed_gap = max(resumed_gap, gap)
            if got.get("ctrl") is not None:
                gaps["ctrl"] = max(gaps["ctrl"],
                                   _pose_gap(got["ctrl"], got["ref"]))
        if j == fb_frame:
            for name, side in sides.items():
                view_pose = poses[j] if got[name] is None else got[name]
                views[name] = _render(cell.render, side.table, view_pose,
                                      slam, side.ar)
        if j > 0:
            for side in sides.values():
                side.consume(j - 1, pyr, poses)
        prev = pyr
    for side in sides.values():
        side.consume(n_run - 1, prev, poses)

    ref_flags = np.asarray(ref.flags, bool)
    differ = ref_flags != diverged[:n_run]
    # the frames on which either side resumed tracking
    at_resume = np.zeros_like(ref_flags)
    at_resume[resumed] = True
    at_resume[1:] |= diverged[:n_run - 1] & ~diverged[1:n_run]
    rkeys, rwords = ref.table.leaves()
    n_ref = rkeys.shape[0]
    numbers = {"pose_gap": gaps["ref"], "diverged_differ": int(differ.sum()),
               "map_diff_share": _map_diff(prog["keys"], prog["words"],
                                           ref.table, n_ref) / max(n_ref, 1),
               "render_diff_share": _render_diff(prog["framebuffer"],
                                                 views["ref"])}
    ctrl = None
    if control:
        side = sides["ctrl"]
        ckeys, cwords = side.table.leaves()
        ctrl = {"pose_gap": gaps["ctrl"],
                "diverged_differ": int((np.asarray(side.flags, bool)
                                        != ref_flags).sum()),
                "map_diff_share": _map_diff(ckeys, cwords, ref.table, n_ref)
                / max(n_ref, 1),
                "render_diff_share": _render_diff(views["ctrl"],
                                                  views["ref"])}
    checks = {k: (v, float(limits[k])) for k, v in numbers.items()}
    redo = {"flags": ref_flags, "attempts": ref.attempts,
            "recoveries": ref.recoveries, "resumed": resumed,
            "lost_at_close": ref.lost,
            "resumed_pose_gap": resumed_gap,
            "resumed_differ": int((differ & at_resume).sum())}
    return checks, ctrl, redo
