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
are held against the
plain reference of slambench/reference/, which works the same frames out
again: `check` below.
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
    failed = int(overflowed[warmup:].sum())
    if res.diverged:
        failed += int(diverged[warmup:].sum())

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
    checks, ctrl = check(cell, stream, prog, n_run, dev, control=control)
    t_check = time.perf_counter() - t_check
    correct = all(v <= lim for v, lim in checks.values())

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


def check(cell: Cell, stream, prog: dict, n_run: int, dev,
          control: bool = False):
    """The reference's judgement of the program's outputs. Returns
    ({number: (value, limit)}, the control's numbers or None).

    The reference follows the program frame by frame: it redoes every
    frame's pyramid and ICP solve from the frame's depth and the previous
    frame's, decides from its own solve whether the frame diverged, and
    fuses the frames it keeps with the program's pose into its own table.
    A divergence both sides flag starts a recovery (the program's
    relocalization, which the reference cannot redo): its frames, up to
    the first the program no longer flags, are neither fused nor compared,
    and the pose of that first one rests on the recovered pose.

    pose_gap: the largest [R | t] entry gap between the program's pose and
      the reference's solve composed with the program's previous pose,
      over every frame the reference follows; the first frame's against
      the pose the run was given.
    diverged_differ: frames whose divergence flag differs from the one the
      reference's own solve gives.
    map_diff_share: leaves that differ in key or word between the
      program's final map and the reference's, over the reference's count.
    render_diff_share: the reference renders its map as it stood at the
      last frame the program rendered, in the cell's mode, from its own
      pose of that frame (the program's where it follows none); the share
      of pixels that differ from the program's view by more than an 8-bit
      level.
    The control is the reference computed in TF32 in the program's place,
    judged by the same numbers."""
    slam = cell.slam
    limits = cell.limits
    n = len(stream)
    poses = torch.from_numpy(prog["poses"]).to(dev)
    diverged = prog["diverged"]
    fb_frame = prog["fb_frame"]
    sides = [("ref", F32)] + ([("ctrl", TF32)] if control else [])
    tables = {name: ref_fusion.MapTable(slam, dev) for name, _ in sides}
    # the start: the first frame keeps the pose the run was given
    gaps = {name: _pose_gap(poses[0], stream.poses[0]) if name == "ref"
            else 0.0 for name, _ in sides}
    differ = {name: 0 for name, _ in sides}
    view_pose: Dict[str, torch.Tensor] = {}
    views: Dict[str, torch.Tensor] = {}
    recovering = False
    prev = None
    for j in range(n_run):
        k = j % n
        pyr = ref_sensor.pyramid(stream.depth[k], slam)
        if recovering and not diverged[j]:
            recovering = False       # the program relocalized before j
            based = False            # j's pose rests on the recovered one
        else:
            based = j > 0 and not diverged[j - 1]
        keep = {name: not recovering for name, _ in sides}
        if j > 0 and not recovering:
            ref_pose = None
            for name, ar in sides:
                T, div = ref_sensor.track(prev, pyr, slam, ar)
                div = bool(div)
                differ[name] += int(div != bool(diverged[j]))
                keep[name] = not div
                if div or not based:
                    continue
                p = ar.mm(poses[j - 1], T)
                if name == "ref":
                    ref_pose = p
                    gaps["ref"] = max(gaps["ref"], _pose_gap(poses[j], p))
                elif ref_pose is not None:
                    gaps["ctrl"] = max(gaps["ctrl"], _pose_gap(p, ref_pose))
                if j == fb_frame:
                    view_pose[name] = p
            recovering = not keep["ref"] and bool(diverged[j])
        for name, ar in sides:
            if keep[name]:
                tables[name].fuse(
                    tables[name].world_points(pyr[0][0], poses[j], ar),
                    stream.color[k])
        if j == fb_frame:
            for name, ar in sides:
                views[name] = _render(cell.render, tables[name],
                                      view_pose.get(name, poses[j]), slam,
                                      ar)
        prev = pyr

    ref = tables["ref"]
    rkeys, rwords = ref.leaves()
    n_ref = rkeys.shape[0]
    numbers = {"pose_gap": gaps["ref"], "diverged_differ": differ["ref"],
               "map_diff_share": _map_diff(prog["keys"], prog["words"], ref,
                                           n_ref) / max(n_ref, 1),
               "render_diff_share": _render_diff(prog["framebuffer"],
                                                 views["ref"])}
    ctrl = None
    if control:
        ckeys, cwords = tables["ctrl"].leaves()
        ctrl = {"pose_gap": gaps["ctrl"], "diverged_differ": differ["ctrl"],
                "map_diff_share": _map_diff(ckeys, cwords, ref, n_ref)
                / max(n_ref, 1),
                "render_diff_share": _render_diff(views["ctrl"],
                                                  views["ref"])}
    checks = {k: (v, float(limits[k])) for k, v in numbers.items()}
    return checks, ctrl
