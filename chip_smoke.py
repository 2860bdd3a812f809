"""Smoke run and report of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the whole run, one card
    python3 chip_smoke.py --profile    # also profile one splat frame by kernel
    python3 chip_smoke.py --profile cone         # ... one slab-cone frame
    python3 chip_smoke.py --profile cone_march   # ... one exact-march frame
    python3 chip_smoke.py --profile cone_hybrid  # ... one hybrid frame

The port's correctness on the card is held by the `cuda` tests
(`python -m pytest tests/test_torch_cuda_*.py --noconftest -q`). This run
keeps what they do not give: each kernel's times and roofline share, the
full-width orbits with their frame times and host reads, and the PSNR
readings. Phases, each of which raises on failure (non-zero exit, no
result line):
  1. device: a CUDA card of compute capability 9.0, strict float32 matmuls;
  2. build: compile the port's kernels from octree_slam_tpu_torch/csrc;
  3. kernel vs plain: each hand-written kernel against its plain PyTorch
     version on the card, bit for bit, with both times: per call including
     the launch (CUDA events, median of 50) and on the device alone
     (50 calls replayed from a CUDA graph, their mean), beside the kernel's bound (the larger of
     its bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s,
     from the shapes of the inputs, slambench/roofline.py) and its share
     of that bound; [splat]: the splat's z-buffer kernel against the plain
     splat_zbuffer at 2, 4 and 8 M live leaves of a 2^23-row registry
     (random occupied leaves in the view's box), word for word, with the
     same times and its byte bound (8 B a live row and the 1.2 MB image
     written twice, over 3.35 TB/s);
  4. main path: the 14-frame synthetic orbit of bench.py (640x480, depth 9,
     2 cm leaves; tests/torch_orbit.py) through pipeline.init_state +
     pipeline.step("splat"), with per-frame CUDA-event times and launch
     counts, and the ATE and map size held to the orbit's known values;
  5. the slab cone at full width: the same orbit through step("cone");
  6. the exact march at full width: the same orbit through
     step("cone_march"), every frame eager, with the march's trip counts
     and the peak device memory; then the last frame's march with its
     live-ray compaction (76,800 of 307,200 lanes) against the all-lanes
     march, in turns: equal word for word, with both CUDA-event times and
     both calls' launches and device time;
  7. the hybrid at full width: the same orbit through step("cone_hybrid")
     with bench.py's band (57,600 lanes, 24 trips), every frame lazy; at
     most 3 host reads a frame; afterwards the mirror it kept must equal,
     word for word, one rebuilt from the pool and stamped; the band's size,
     the share of its rays still active at the trip cap and the peak
     device memory are printed; the band's trips run as the kernel
     band_march, one launch a frame (every splat frame's z-buffer is one
     launch of splat_zbuffer, in every phase); on the last frame the kernel's
     outputs and live lane-trips must equal the eager loop's word for
     word, and its row gives both paths' per-call and device ms, its byte
     bound (each gather one 32-byte sector, over 3.35 TB/s) and launches;
  8. the step features at full width: the splat orbit with the insert's
     directory cache on must end with the splat orbit's leaf registry,
     node count and ATE; the orbit with the keyframe anchor and the
     saturation gate on must not diverge, keep its ATE under 0.01 m and
     end with the mask that rebuild_sat_mask makes;
  9. fidelity, as bench.py measures it: a map built by 13 splat frames,
     the last frame rendered by the slab cone, the exact march and the
     hybrid from copies of the state, and the two PSNRs against the march
     (cone_psnr_db, cone_hybrid_psnr_db: the hybrid's must be the higher);
     then that heal_for_march is idempotent;
 10. tum: a 14-frame 640x480 TUM-format sequence written by the port and
     replayed through its CLI, with slam_fps (frames staged on the card)
     and e2e_fps_incl_decode_upload (decoded and uploaded by the feeder),
     and the per-array ingest (prefetched(packed=False)) equal to it;
     [native]: whether the native host I/O runtime (io/native.py) built,
     which PNG decoder the TUM reader took, and the native decode of the
     sequence's files against the pure decoder, byte for byte;
 11. entry points: the same orbit through app.run_slam, through it at
     capacities small enough to grow, through it with a frame blanked so
     that it recovers (and one recovery attempt alone, whose launches'
     batch the kernels' JSON line gives), through run_slam_2d on the 1 x 8
     and 2 x 4 meshes and through the CLI with --save-mesh, each with its
     launch counts, wall time and host reads; the `cuda` tests hold these
     runs' results and counts, so this phase checks nothing;
 12. knobs: bilateral_window, the bilateral of any window size, against
     its plain version: each compiled radius (sizes 3, 5, 9, 11, 13) on
     the main path's frame, sizes 5 and 11 on a ragged frame and the
     recovery batch, and the run-time-radius kernel at size 15, each line
     naming the instance that ran; the orbit through step("splat") at a
     5x5 window (bilateral_window's main path) held to its pinned ATE,
     nodes and leaves; the 2 x 4 mesh's row slabs at an 11x11 window,
     each slab's pyramid equal to the whole frame's; on
     [fidelity]'s map the hybrid with each band knob (sel_decimate,
     depth_prio 0.5, crawl 4 at 6 and at 24 trips, compact_after 8, 96
     trips fixed and compacting after 8) and
     the slab cone in each mode (accumulate, blend 0.25, bilinear), each
     with its PSNR against the exact march, render ms and device
     operations; compact_after 8 gives the fixed-trip image bit for bit,
     and at 96 trips it packs its live lanes and still does;
     the crawl keeps the reference's contract (4 x 8 within 0.3 dB of
     1 x 32) on the reference's own 80x60 scene, and its gap at full
     width (4 x 6 against 1 x 24) is printed.
Every orbit starts with the kernels' launch counts at 0; in phases 4-10
and 12 it must find each kernel of its path launched once per frame and
the others never. The last
lines are the card's name and power limit, a JSON line of the kernels, and
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import importlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from slambench.roofline import (PEAK_BYTES_PER_S, PEAK_F32_PER_S,
                                bilateral_work, bound_s, gated_pyramid_work)


def _test_helper(name: str):
    """A JAX-free helper module of tests/; the directory goes at the end
    of sys.path, so it shadows no module."""
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if d not in sys.path:
        sys.path.append(d)
    return importlib.import_module(name)


# the benchmark orbit, its pins and the host-read counter
orb = _test_helper("torch_orbit")
ORBIT_PIN = (orb.ORBIT_ATE_M, orb.ORBIT_MAP_NODES, orb.ORBIT_MAP_LEAVES)

# Every kernel follows its plain version op for op (same tap order, expf,
# IEEE division, rintf / truncation, no FMA contraction), so the tolerance
# is 0 mm: every output pixel must be equal. KERNELS are the kernels of the
# main path (the 7x7 window); each case is (shape, levels), the first the
# main path's, whose times go into the JSON line.
KERNELS = {
    "bilateral7x7": {
        "replaces": "octree_slam_tpu/sensor/pallas_ops.py:149",
        "cases": [((480, 640), None), ((1080, 1920), None),
                  ((479, 641), None), ((483, 645), None),
                  ((4, 240, 320), None), ((2, 1080, 1920), None),
                  ((4, 480, 640), None)],
    },
    "gated_pyramid5x5": {
        "replaces": "octree_slam_tpu/sensor/pallas_ops.py:160",
        "cases": [((480, 640), 2), ((479, 641), 2), ((483, 645), 2),
                  ((4, 240, 320), 2), ((480, 640), 1), ((240, 320), 1),
                  ((4, 480, 640), 2)],
    },
}
# the bilateral of any other window size, the path of the config's
# bilateral_kernel_size != 7 ([knobs]); its cases are (shape, kernel size),
# the first its main path's: the splat orbit at a 5x5 window. Every
# compiled radius (1, 2, 4, 5, 6; radius 3 is bilateral7x7) on the frame,
# sizes 5 and 11 on a ragged frame and on the recovery batch, and size 15
# for the run-time-radius kernel
WINDOW_KERNEL = "bilateral_window"
WINDOW_REPLACES = "octree_slam_tpu/sensor/image_ops.py:88"
WINDOW_SIZE = 5
WINDOW_CASES = [((480, 640), 5), ((480, 640), 3), ((480, 640), 9),
                ((480, 640), 11), ((480, 640), 13), ((479, 641), 5),
                ((479, 641), 11), ((4, 480, 640), 5), ((4, 480, 640), 11),
                ((480, 640), 15)]
# the row-sharded pyramid's window in [knobs]: the widest case
WINDOW_HALO_SIZE = 11
SOURCE = "octree_slam_tpu_torch/csrc/sensor_stencils.cu"
# the hybrid's band march: no Pallas kernel, the reference's device loop
BAND_SOURCE = "octree_slam_tpu_torch/csrc/band_march.cu"
BAND_REPLACES = ("none: the lax.while_loop of "
                 "octree_slam_tpu/render/hybrid.py:420")
# the splat's z-buffer: no Pallas kernel, the reference's plain XLA
SPLAT_SOURCE = "octree_slam_tpu_torch/csrc/splat.cu"
SPLAT_REPLACES = ("none: splat_zbuffer of octree_slam_tpu/render/splat.py, "
                  "plain XLA")
# [splat]: the registry's rows and the live leaves of each case
SPLAT_CAPACITY = 1 << 23
SPLAT_LEAVES = (2_000_000, 4_000_000, 8_000_000)
# the same orbit at a WINDOW_SIZE window (bilateral_window is bit-exact
# against its plain version too): ATE (tolerance orb.ORBIT_ATE_TOL_M), nodes,
# leaves
WINDOW_ORBIT_PIN = (0.0018001, 425_920, 74_050)
# the slab cone against the exact march on one map, in dB
CONE_PSNR_FLOOR_DB = 25.0
# a feature orbit's own trajectory bound (the verify skill's good output)
FEATURE_ATE_MAX_M = 0.01
# rounds of the exact march's timing, compacted and all lanes in turns
MARCH_COMPACTION_RUNS = 9


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def phase_device():
    check(torch.cuda.is_available(),
          "no CUDA device: the port's smoke run needs a GPU")
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0].strip()
    from octree_slam_tpu_torch import _build
    nvcc = _run([_build.find_nvcc(), "--version"])
    release = re.search(r"release [^\s,]+", nvcc)
    cap = torch.cuda.get_device_capability(0)
    print(f"[device] {smi} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | nvcc {release.group(0) if release else '?'}"
          f" | capability {cap} | devices {torch.cuda.device_count()}")
    check(cap == (9, 0), f"expected compute capability (9, 0), got {cap}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: ICP needs strict float32 products")
    return smi


def phase_build():
    from octree_slam_tpu_torch import _build
    t0 = time.perf_counter()
    _build.library()
    info = _build.BUILD_INFO
    print(f"[build] route {info['route']} | "
          f"{'cached' if info['cached'] else 'compiled'} in "
          f"{time.perf_counter() - t0:.2f} s | {info['path']}")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"[build]   {line.strip()}")


def _depth(shape, gen):
    """int32 depth of a noisy surface on the card: a slanted wave (about
    1,000 to 4,100 mm at 640x480), a 300 mm step at mid-width, noise of 15
    mm (within the bilateral's sigma_depth of 40 mm, so every tap of its
    window carries weight and the gate passes most taps) and 5% zero
    holes."""
    h, w = shape[-2:]
    y = torch.arange(h, device="cuda", dtype=torch.float64)[:, None]
    x = torch.arange(w, device="cuda", dtype=torch.float64)[None, :]
    base = (2000 + 500 * torch.sin(x / 37 + 0.3 * y / 23)
            * torch.cos(y / 29) + 2 * x - y + 300 * (x >= w // 2))
    noise = torch.randn(shape, generator=gen, device="cuda",
                        dtype=torch.float64)
    d = torch.clamp(torch.round(base + 15 * noise), 400, 6000)
    holes = torch.rand(shape, generator=gen, device="cuda") < 0.05
    return torch.where(holes, 0, d).to(torch.int32).contiguous()


def _bound(nbytes: int, ops: int):
    """The least time the card could take: (ms, what sets it)."""
    by = ("bytes" if nbytes / PEAK_BYTES_PER_S >= ops / PEAK_F32_PER_S
          else "operations")
    return 1e3 * bound_s(nbytes, ops), by


def _case_calls(name, param):
    """(kernel, plain, work, label) for one case: callables of a depth
    tensor returning a list of outputs, the bound's (bytes, operations) of
    a shape, and the case's label suffix. `param` is the gated pyramid's
    levels or bilateral_window's kernel size."""
    from octree_slam_tpu_torch.sensor import cuda_ops
    if name == "bilateral7x7":
        return (lambda d: [cuda_ops.bilateral(d, 4.5, 40.0)],
                lambda d: [cuda_ops.bilateral_plain(d, 4.5, 40.0)],
                bilateral_work, "")
    if name == WINDOW_KERNEL:
        return (lambda d: [cuda_ops.bilateral(d, 4.5, 40.0, param)],
                lambda d: [cuda_ops.bilateral_plain(d, 4.5, 40.0, param)],
                lambda shape: bilateral_work(shape, param),
                f" kernel_size {param} "
                f"({cuda_ops.bilateral_instance(param)} instance)")
    return (lambda d: cuda_ops.gated_pyramid(d, 120.0, param),
            lambda d: cuda_ops.gated_pyramid_plain(d, 120.0, param),
            lambda shape: gated_pyramid_work(shape, param),
            f" levels {param}")


def _kernel_case(name, shape, param, gen, runs=50):
    """One kernel on a random depth of `shape` against its plain version:
    fails unless every output pixel is equal; prints and returns the
    times, the bound and the largest difference (0)."""
    from octree_slam_tpu_torch.sensor import cuda_ops
    from octree_slam_tpu_torch.utils.timing import device_ms, median_ms
    kernel, plain, work, suffix = _case_calls(name, param)
    d = _depth(shape, gen)
    before = cuda_ops.LAUNCHES[name]
    outs, refs = kernel(d), plain(d)
    torch.cuda.synchronize()
    label = f"{name} {shape}{suffix}"
    check(cuda_ops.LAUNCHES[name] == before + 1,
          f"{label}: the wrapper did not launch {name}")
    check(len(outs) == len(refs), f"{label}: {len(outs)} outputs")
    worst = n_off = n_all = 0
    for out, ref in zip(outs, refs):
        check(out.shape == ref.shape and out.dtype == ref.dtype,
              f"{label}: {tuple(out.shape)} vs {tuple(ref.shape)}")
        diff = (out.to(torch.int64) - ref).abs()
        if diff.numel():
            worst = max(worst, int(diff.max()))
        n_off += int((diff > 0).sum())
        n_all += diff.numel()
    ms = median_ms(lambda: kernel(d), runs=runs)
    pms = median_ms(lambda: plain(d), runs=runs)
    dms = device_ms(lambda: kernel(d), runs=runs)
    pdms = device_ms(lambda: plain(d), runs=runs)
    bms, by = _bound(*work(shape))
    print(f"[kernel] {label}: {n_off} of {n_all} pixels differ | per call "
          f"incl. launch (median of {runs}): kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms | device only (graph of {runs}): kernel {dms:.4f} "
          f"ms, plain {pdms:.4f} ms | bound {bms:.5f} ms ({by}), "
          f"{100 * bms / dms:.1f}% of it on the device")
    check(n_off == 0, f"{label}: {n_off} of {n_all} pixels differ from the "
          f"plain version, tolerance 0 mm")
    return {"ms": ms, "plain_ms": pms, "device_ms": dms,
            "plain_device_ms": pdms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "max_abs_err": worst}


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {}
    for name, spec in KERNELS.items():
        cases = [_kernel_case(name, shape, levels, gen)
                 for shape, levels in spec["cases"]]
        report[name] = dict(cases[0], max_abs_err=max(
            c["max_abs_err"] for c in cases))
    return report


def splat_zbuffer_bytes(live: int, width: int, height: int) -> int:
    """Bytes the splat's z-buffer moves at the least: each live row's key
    and word (8 B) read once, and the i32 image written twice (the fill,
    then the words). Its float operations (~60 a live row) and the
    atomics into the L2-resident image are far below the bytes' time."""
    return 8 * live + 2 * 4 * width * height


def _splat_case(smi: str, cfg, live: int, gen):
    """The splat kernel on a registry of SPLAT_CAPACITY rows whose first
    `live` are random occupied leaves in a 4 x 3 x 4 m box 0.5 m in front
    of the camera (about 26 a pixel at 8 M), the rest free, against the
    plain splat_zbuffer: word for word, with both paths' CUDA-event ms a
    call (launch included) and device ms (calls replayed from a CUDA
    graph), and the kernel's bound. Returns the case's row."""
    from octree_slam_tpu_torch.core import packing
    from octree_slam_tpu_torch.map import morton
    from octree_slam_tpu_torch.render import splat, splat_ops
    from octree_slam_tpu_torch.utils.timing import device_ms, median_ms
    dev = torch.device("cuda")
    lc, half = SPLAT_CAPACITY, 2.56
    center = torch.zeros(3, device=dev)
    half_t = torch.tensor(half, device=dev)
    lo = torch.tensor([-2.0, -1.5, 0.5], device=dev)
    pts = lo + torch.rand((live, 3), generator=gen, device=dev) \
        * torch.tensor([4.0, 3.0, 4.0], device=dev)
    keys = torch.full((lc,), -1, dtype=torch.int32, device=dev)
    keys[:live] = morton.encode(pts, center, half, cfg.max_depth)[0]
    rgb = torch.randint(0, 256, (live, 3), generator=gen, device=dev)
    vals = torch.zeros((lc,), dtype=torch.int32, device=dev)
    vals[:live] = packing.pack_rgba8(rgb[:, 0], rgb[:, 1], rgb[:, 2],
                                     torch.full_like(rgb[:, 0], 200))
    count = torch.tensor(live, dtype=torch.int32, device=dev)
    pose = torch.eye(4, device=dev)
    del pts, rgb
    kw = dict(width=cfg.width, height=cfg.height, depth=cfg.max_depth,
              max_range=cfg.max_range)

    def kernel():
        return splat_ops.splat_zbuffer(vals, keys, count, center, half_t,
                                       pose, cfg.focal_x, cfg.focal_y,
                                       **kw)[0]

    def plain():
        lv = (torch.arange(lc, device=dev) < count) & (keys >= 0)
        return splat.splat_zbuffer(vals, keys, lv, center, half_t, pose,
                                   cfg.focal_x, cfg.focal_y, **kw)

    before = splat_ops.LAUNCHES[splat_ops.KERNEL]
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    check(splat_ops.LAUNCHES[splat_ops.KERNEL] == before + 1,
          "[splat] the wrapper did not launch splat_zbuffer")
    off = int((got != want).sum())
    hits = int((want != splat.EMPTY).sum())
    check(off == 0, f"[splat] splat_zbuffer at {live} leaves: {off} words "
          f"differ from the plain version")
    check(hits > cfg.width * cfg.height // 2,
          f"[splat] {hits} pixels hit at {live} leaves")
    ms, pms = median_ms(kernel), median_ms(plain, runs=9)
    dms, pdms = device_ms(kernel), device_ms(plain, runs=9)
    nbytes = splat_zbuffer_bytes(live, cfg.width, cfg.height)
    bms, by = _bound(nbytes, 0)
    print(f"[splat] {smi} | splat_zbuffer {live} live of {lc} rows, "
          f"{hits} pixels hit: {off} words differ from the plain version | "
          f"per call incl. launch and fill: kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms | device only (graph): kernel {dms:.4f} ms, plain "
          f"{pdms:.4f} ms | bound {bms:.5f} ms ({by}: {nbytes} B), "
          f"{100 * bms / dms:.1f}% of it on the device")
    return {"live_leaves": live, "rows": lc, "pixels_hit": hits,
            "bytes": nbytes, "ms": ms, "plain_ms": pms, "device_ms": dms,
            "plain_device_ms": pdms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "max_abs_err": 0, "launches_per_call": 1}


def phase_splat(smi: str, cfg):
    """[splat]: the splat kernel's cases at SPLAT_LEAVES; returns the rows
    by live leaves."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for live in SPLAT_LEAVES:
        rows[live] = _splat_case(smi, cfg, live, gen)
        torch.cuda.empty_cache()
    return rows


def _drive_orbit(cfg, frames, gts, render: str, label: str):
    """The orbit through init_state + step(render) with the kernels'
    launch counts set to 0 just before and read just after; per-frame
    CUDA-event times of the frames after the warm-up, and the last frame's
    count of synchronising host reads."""
    from octree_slam_tpu_torch import pipeline
    from octree_slam_tpu_torch.render import band_ops, splat_ops
    from octree_slam_tpu_torch.sensor import cuda_ops
    from octree_slam_tpu_torch.utils.metrics import ate_rmse
    from octree_slam_tpu_torch.utils.timing import EventTimer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    band_ops.reset_launches()
    splat_ops.reset_launches()
    t0 = time.perf_counter()
    state = pipeline.init_state(cfg, initial_pose=gts[0], device="cuda")
    sizes = []
    for i in range(orb.ORBIT_WARMUP):
        state, out = pipeline.step(state, frames[i], cfg, render=render)
        sizes.append(torch.stack([out.map_nodes, out.map_leaves]))
    timer = EventTimer()
    est, host_ms = [], []
    for i in range(orb.ORBIT_WARMUP, len(frames) - 1):
        t1 = time.perf_counter()
        with timer.time("frame"):
            state, out = pipeline.step(state, frames[i], cfg, render=render)
        host_ms.append(1e3 * (time.perf_counter() - t1))
        est.append(out.pose)
        sizes.append(torch.stack([out.map_nodes, out.map_leaves]))
    with orb.HostReads() as reads, timer.time("frame"):
        state, out = pipeline.step(state, frames[-1], cfg, render=render)
    est.append(out.pose)
    sizes.append(torch.stack([out.map_nodes, out.map_leaves]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)

    ms = timer.ms("frame")
    sizes = torch.stack(sizes).tolist()
    fb = out.framebuffer
    res = {
        "render": render, "path": label,
        "frame_ms_median": statistics.median(ms),
        "frame_ms_p90": float(np.percentile(ms, 90)),
        "host_frame_ms_median": statistics.median(host_ms),
        "fps": 1000.0 * len(ms) / sum(ms),
        "ate_rmse_m": ate_rmse(
            np.stack([p.cpu().numpy() for p in est]),
            np.stack([g.cpu().numpy() for g in gts[orb.ORBIT_WARMUP:]])),
        "map_nodes": int(out.map_nodes), "map_leaves": int(out.map_leaves),
        "diverged": bool(out.diverged),
        "map_overflowed": bool(out.map_overflowed),
        "fb_hit_pixels": int((fb[..., :3].sum(-1) > 0).sum()),
        "launches": launches, "host_reads_last_frame": reads.count,
        "band_launches": band_ops.LAUNCHES[band_ops.KERNEL],
        "splat_launches": splat_ops.LAUNCHES[splat_ops.KERNEL],
        # (nodes, leaves) after each frame, read once after the run
        "map_size_by_frame": sizes,
        "wall_s_with_warmup": wall,
        "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20,
    }
    return state, out, res


def _check_orbit(smi: str, cfg, out, res, n_frames: int, pinned):
    """The checks every orbit must pass, whatever its render. `pinned`,
    (ATE, nodes, leaves), holds the trajectory and the map to an orbit's
    known values (the ATE within orb.ORBIT_ATE_TOL_M); an orbit that tracks
    another way (the keyframe anchor), with `pinned` None, has its own
    trajectory and is held to FEATURE_ATE_MAX_M."""
    tag = f"[{res['path']}]"
    print(f"{tag} {smi} | 640x480 depth 9 2 cm, {n_frames - orb.ORBIT_WARMUP} "
          f"timed frames after {orb.ORBIT_WARMUP} warm-up | frame ms median "
          f"{res['frame_ms_median']:.3f} p90 {res['frame_ms_p90']:.3f} | "
          f"{res['fps']:.2f} frames/s")
    print(f"{tag} {smi} | " + json.dumps(res))
    fb = out.framebuffer
    check(fb.shape == (cfg.height, cfg.width, 4)
          and bool(torch.isfinite(fb).all()),
          f"{tag} framebuffer shape/finiteness")
    check(not res["diverged"], f"{tag} tracking diverged")
    check(not res["map_overflowed"], f"{tag} map overflowed")
    if pinned:
        # fusion does not depend on the render: every orbit of one window
        # builds one map
        ate, nodes, leaves = pinned
        check(abs(res["ate_rmse_m"] - ate) <= orb.ORBIT_ATE_TOL_M,
              f"{tag} ATE {res['ate_rmse_m']:.9f} m, expected {ate} "
              f"+- {orb.ORBIT_ATE_TOL_M} m")
        check(res["map_nodes"] == nodes,
              f"{tag} map nodes {res['map_nodes']}, expected {nodes}")
        check(res["map_leaves"] == leaves,
              f"{tag} map leaves {res['map_leaves']}, expected {leaves}")
    else:
        check(res["ate_rmse_m"] < FEATURE_ATE_MAX_M,
              f"{tag} ATE {res['ate_rmse_m']:.6f} m, expected under "
              f"{FEATURE_ATE_MAX_M} m")
        check(res["map_leaves"] > orb.ORBIT_MAP_LEAVES // 2,
              f"{tag} map leaves {res['map_leaves']}")
    check(res["fb_hit_pixels"] > 0, f"{tag} framebuffer has no lit pixels")
    on_path = _path_kernels(cfg)
    for name, n in res["launches"].items():
        want = n_frames if name in on_path else 0
        check(n == want, f"{tag} {name} launches {n} != {want}")
    # the band kernel: one launch a hybrid frame, none on other renders
    want = n_frames if res["render"] == "cone_hybrid" else 0
    check(res["band_launches"] == want,
          f"{tag} band_march launches {res['band_launches']} != {want}")
    # the splat's z-buffer kernel: one launch a splat frame
    want = n_frames if res["render"] == "splat" else 0
    check(res["splat_launches"] == want,
          f"{tag} splat_zbuffer launches {res['splat_launches']} != {want}")


def _path_kernels(cfg):
    """The kernels a frame of `cfg` launches: the bilateral of its window
    (bilateral7x7 for radius 3, else bilateral_window) and the pyramid."""
    half = cfg.bilateral_kernel_size // 2
    return ("bilateral7x7" if half == 3 else WINDOW_KERNEL,
            "gated_pyramid5x5")


def _march_trips(state, cfg):
    """Trips that each phase of the exact march needs from state.pose on
    the state's (current) mirror, and the per-pixel finishing trips."""
    from octree_slam_tpu_torch import pipeline
    from octree_slam_tpu_torch.render import raycast
    _, dbg = raycast.cone_trace_dense(
        state.accel, state.pool.center, state.pool.half_size, state.pose,
        cfg.focal_x, cfg.focal_y, width=cfg.width, height=cfg.height,
        max_depth=cfg.max_depth, dist_level=pipeline._accel_level(cfg),
        max_iters=cfg.max_march_iters, max_range=cfg.max_range,
        start_dist=cfg.start_dist, debug_iters=True)
    fin = dbg["fin"].float()
    return {"p1_trips": int(dbg["p1_trips"]), "p2_trips": int(dbg["p2_trips"]),
            "fin_trip_median": float(fin.median()),
            "fin_trip_p99": float(fin.flatten().kthvalue(
                int(0.99 * fin.numel())).values),
            "rays_unfinished": int((dbg["fin"] >= cfg.max_march_iters).sum()),
            # rays still live after each exit test's trip
            "live_after_trip": {t: int((dbg["fin"] > t).sum()) for t in range(
                raycast.EXIT_CHECK_EVERY, cfg.max_march_iters,
                raycast.EXIT_CHECK_EVERY)}}


def _march_compaction(smi: str, state, cfg, trips):
    """The exact march of the orbit's last frame with its live-ray
    compaction (cone_trace_dense's defaults) and over all lanes
    (compact_after = max_march_iters), in turns: the framebuffers word for
    word, the CUDA-event ms of a call (median of MARCH_COMPACTION_RUNS
    rounds), and the kernels and device time of one call under
    torch.profiler. `trips` is _march_trips' of the same frame: where the
    compaction happens and how many lanes were live there."""
    import inspect
    from torch.profiler import ProfilerActivity, profile
    from octree_slam_tpu_torch import pipeline
    from octree_slam_tpu_torch.render import raycast
    from octree_slam_tpu_torch.utils.timing import EventTimer
    n = cfg.width * cfg.height
    lanes = max(128, n // 4)
    after = inspect.signature(
        raycast.cone_trace_dense).parameters["compact_after"].default
    live = trips["live_after_trip"]
    packed_at = next((t for t in sorted(live) if t >= after
                      and 0 < live[t] <= lanes), None)
    runs = {"compacted": {}, "all_lanes": {
        "compact_after": cfg.max_march_iters}}

    def march(kw):
        return raycast.cone_trace_dense(
            state.accel, state.pool.center, state.pool.half_size, state.pose,
            cfg.focal_x, cfg.focal_y, width=cfg.width, height=cfg.height,
            max_depth=cfg.max_depth, dist_level=pipeline._accel_level(cfg),
            max_iters=cfg.max_march_iters, max_range=cfg.max_range,
            start_dist=cfg.start_dist, max_skip=cfg.dist_max_skip, **kw)

    fbs, res = {}, {}
    for name, kw in runs.items():
        fbs[name] = march(kw)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            march(kw)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        res[name] = {
            "launches": sum(e.count for e in kernels),
            "device_busy_ms": sum(e.self_device_time_total
                                  for e in kernels) / 1e3}
    timer = EventTimer()
    for _ in range(MARCH_COMPACTION_RUNS):
        for name, kw in runs.items():
            with timer.time(name):
                march(kw)
    for name in runs:
        res[name]["ms_median"] = statistics.median(timer.ms(name))
        res[name]["ms_all"] = timer.ms(name)
    words = [fb.view(torch.int32) for fb in fbs.values()]
    off = int((words[0] != words[1]).sum())
    print(f"[cone_march] {smi} | live-ray compaction: {n} lanes, "
          f"{lanes} after compaction; {live.get(after)} rays live after "
          f"trip {after}; packs after trip {packed_at} "
          f"({live.get(packed_at)} live); {off} of {words[0].numel()} "
          f"framebuffer words differ from the all-lanes march; "
          f"{MARCH_COMPACTION_RUNS} rounds in turns: " + json.dumps(res))
    check(off == 0, f"[cone_march] the compacted march differs from the "
          f"all-lanes march in {off} framebuffer words")
    check(packed_at is not None,
          "[cone_march] the live rays never fit the compacted lanes")
    return res


def _hybrid_mirror_check(smi: str, state, cfg, res):
    """After a hybrid orbit: the flags a lazy hybrid frame leaves; the
    band's size and the share of its rays the trip cap cut; and the mirror
    the frames kept by two scatters a frame against one rebuilt from the
    refreshed pool and stamped, word for word on the leaf level, occ and
    dist."""
    from octree_slam_tpu_torch import pipeline
    from octree_slam_tpu_torch.map import mips
    from octree_slam_tpu_torch.render import hybrid
    check(bool(state.interior_stale) and not bool(state.mirror_stale)
          and not bool(state.stamps_stale),
          "[cone_hybrid] a lazy hybrid frame must leave interior_stale "
          "true, mirror_stale and stamps_stale false")
    lvl = pipeline._accel_level(cfg)
    _, dbg = hybrid.render_cone_hybrid(
        state.leaves, state.accel, state.pool.center, state.pool.half_size,
        state.pose, cfg.focal_x, cfg.focal_y, spec=pipeline._slab_spec(cfg),
        depth=cfg.max_depth, dist_level=lvl, max_range=cfg.max_range,
        start_dist=cfg.start_dist, band_cap=cfg.cone_band_cap,
        band_iters=cfg.cone_band_iters, fused_dist=cfg.cone_band_fused_dist,
        debug_band=True)
    lanes = dbg["sel"].numel()
    band = {"band_lanes": lanes,
            "band_share_of_pixels": lanes / (cfg.width * cfg.height),
            "trips": dbg["trips"],
            "active_at_cap_share": float(dbg["capped"].float().mean()),
            "marched_share": float(dbg["use_march"].float().mean()),
            "peak_mem_mb": res["peak_mem_mb"]}
    print(f"[cone_hybrid] {smi} | last frame's band: " + json.dumps(band))
    check(lanes == orb.HYBRID_BAND["cone_band_cap"], f"band of {lanes} lanes")
    check(0.0 < band["marched_share"], "[cone_hybrid] no ray was marched")

    # heal_for_march refreshes the pool it is given in place: give it a copy
    twin = state._replace(pool=state.pool._replace(
        child=state.pool.child.clone(), value=state.pool.value.clone()))
    _, fresh = pipeline.heal_for_march(twin, cfg)
    fresh = mips.encode_free_dist(fresh, max_depth=cfg.max_depth,
                                  dist_level=lvl)
    lo = mips.level_offset(cfg.max_depth)
    kept = state.accel
    off = {"leaf level": int((kept.values[lo:] != fresh.values[lo:]).sum()),
           "occ": int((kept.occ != fresh.occ).sum()),
           "dist": int((kept.dist != fresh.dist).sum())}
    stamped = int(((kept.values[lo:] >= 0) & (kept.values[lo:] < 256)).sum())
    print(f"[cone_hybrid] kept mirror against rebuilt + stamped: differing "
          f"cells {json.dumps(off)} of {kept.values.numel() - lo} leaf "
          f"cells, {kept.occ.numel()} dist cells; {stamped} cells stamped, "
          f"{int(kept.occ.sum())} dist cells occupied")
    check(not any(off.values()),
          f"[cone_hybrid] the kept mirror is not the rebuilt one: {off}")
    check(stamped > 0, "[cone_hybrid] no free cell carries a stamp")


def band_march_work(lanes: int, gathers: int) -> int:
    """Bytes the band march moves at the least: each lane's inputs (dirs
    and inv_dirs f32[3], limit and start f32, miss bool) read once and
    its outputs (rgb f32[3], w f32, active bool) written once, and each
    gather of the mirror (one a live lane-trip with fused_dist, two
    without) charged one 32-byte sector. Its float operations (~60 a
    lane-trip) are far below the bytes' time."""
    return lanes * (12 + 12 + 4 + 4 + 1 + 12 + 4 + 1) + 32 * gathers


def _band_kernel_row(smi: str, state, cfg):
    """The band kernel at the production shape, on the orbit's last frame:
    its lanes, live lane-trips and outputs against the eager loop's (word
    for word), each path's CUDA-event ms a call (launch included) and its
    device ms (calls replayed from a CUDA graph), and the kernel's bound.
    Returns the kernel's row."""
    from octree_slam_tpu_torch import pipeline
    from octree_slam_tpu_torch.render import band_ops, conesplat, hybrid
    from octree_slam_tpu_torch.utils.timing import device_ms, median_ms
    spec = pipeline._slab_spec(cfg)
    fb, _, z_first = conesplat.render_cone_splat(
        state.leaves, state.pool.center, state.pool.half_size, state.pose,
        cfg.focal_x, cfg.focal_y, spec=spec, depth=cfg.max_depth,
        want_aux=True)
    C = cfg.cone_band_cap
    # band_march_merge's defaults: grad_dilate 2, seed_halo 4
    sel = hybrid._select(fb, z_first, spec, C, 2, cfg.cone_band_depth_prio,
                         cfg.cone_band_sel_decimate)
    lanes = hybrid._rays(
        sel, z_first, state.pool.center, state.pool.half_size, state.pose,
        cfg.focal_x, cfg.focal_y, spec=spec, depth=cfg.max_depth,
        max_range=cfg.max_range, start_dist=cfg.start_dist, seed_halo=4)
    kw = dict(depth=cfg.max_depth, dist_level=pipeline._accel_level(cfg),
              max_range=cfg.max_range, band_iters=cfg.cone_band_iters,
              fused_dist=cfg.cone_band_fused_dist)
    args = (*lanes, state.accel, state.pool.center, state.pool.half_size)

    def kernel(count_live=False):
        return band_ops.band_march(*args, count_live=count_live, **kw)

    def plain(count_live=False):
        return hybrid._trips_eager(
            *args, compact_after=cfg.cone_band_compact_after, crawl=1,
            C2=max(128, C // 4), count_live=count_live, **kw)

    before = band_ops.LAUNCHES[band_ops.KERNEL]
    got, want = kernel(True), plain(True)
    torch.cuda.synchronize()
    check(band_ops.LAUNCHES[band_ops.KERNEL] == before + 1,
          "[cone_hybrid] the wrapper did not launch band_march")
    off = sum(int((g != x).sum()) for g, x in zip(got[:3], want[:3]))
    live = int(got[3])
    check(off == 0 and live == int(want[5]),
          f"[cone_hybrid] band_march: {off} output words differ from the "
          f"eager loop; live lane-trips {live} against {int(want[5])}")
    ms, pms = median_ms(kernel), median_ms(plain, runs=9)
    dms, pdms = device_ms(kernel), device_ms(plain, runs=9)
    gathers = live * (1 if cfg.cone_band_fused_dist else 2)
    nbytes = band_march_work(C, gathers)
    bms, by = _bound(nbytes, 0)
    row = {"lanes": C, "trips": cfg.cone_band_iters, "live_lane_trips": live,
           "fused_dist": cfg.cone_band_fused_dist, "bytes": nbytes,
           "ms": ms, "plain_ms": pms, "device_ms": dms,
           "plain_device_ms": pdms, "bound_ms": bms, "bound_by": by,
           "library_ms": None, "max_abs_err": 0,
           "launches_per_call": 1}
    print(f"[cone_hybrid] {smi} | band_march {C} lanes x "
          f"{cfg.cone_band_iters} trips, {live} live lane-trips: {off} "
          f"output words differ from the eager loop | per call incl. "
          f"launch: kernel {ms:.4f} ms, plain {pms:.4f} ms | device only "
          f"(graph): kernel {dms:.4f} ms, plain {pdms:.4f} ms | bound "
          f"{bms:.5f} ms ({by}: {nbytes} B), {100 * bms / dms:.1f}% of it "
          f"on the device | launches " + json.dumps(band_ops.LAUNCHES))
    return row


def phase_orbit(smi: str, cfg, frames, gts, render: str, profile,
                label: str | None = None, pinned=ORBIT_PIN,
                most_reads: int = 1):
    """The orbit through step(render) with the checks every render must
    pass. A cone_march orbit is eager on every frame (the insert re-mipmaps
    and updates the dense mirror); its march's trips are printed. A
    cone_hybrid orbit is lazy on every frame and keeps the mirror's leaf
    level itself. Returns (launches, final state, result)."""
    from octree_slam_tpu_torch.render.raycast import EXIT_CHECK_EVERY
    label = label or render
    state, out, res = _drive_orbit(cfg, frames, gts, render, label)
    _check_orbit(smi, cfg, out, res, len(frames), pinned)
    # the remainder pager's read of unique_overflow and nothing else; a
    # march frame adds the heal's read of the stale flags and each march
    # phase's exit test once every EXIT_CHECK_EVERY trips; a lazy hybrid
    # frame reads the pager (with the new-leaf flag) and the stale flags
    most = {"cone_march": 2 + 2 * (cfg.max_march_iters // EXIT_CHECK_EVERY),
            "cone_hybrid": 3}.get(render, most_reads)
    check(1 <= res["host_reads_last_frame"] <= most,
          f"[{label}] {res['host_reads_last_frame']} host reads in a "
          f"frame, expected 1 to {most}")
    if render == "cone_hybrid":
        _hybrid_mirror_check(smi, state, cfg, res)
        res["band_march"] = _band_kernel_row(smi, state, cfg)
    if render == "cone_march":
        check(not bool(state.interior_stale)
              and not bool(state.mirror_stale),
              "[cone_march] the march left its map stale")
        trips = _march_trips(state, cfg)
        print(f"[cone_march] {smi} | last frame's march: "
              + json.dumps(trips) + f" of at most {cfg.max_march_iters} "
              f"trips a phase | peak device memory "
              f"{res['peak_mem_mb']:.1f} MiB")
        check(trips["p2_trips"] > 0, "[cone_march] the march sampled nothing")
        res["compaction"] = _march_compaction(smi, state, cfg, trips)
    if profile == render and label == render:
        _profile_frame(smi, state, frames[-3:], cfg, res["frame_ms_median"],
                       render)
    return res["launches"], state, res


def phase_features(smi: str, cfg, frames, gts, splat_registry):
    """Phase 8: the orbit with the insert's directory cache, held to the
    splat orbit's map; the orbit with the keyframe anchor and the
    saturation gate, held to its own ATE bound and to the rebuilt mask."""
    from octree_slam_tpu_torch import pipeline
    launches = {}
    cached = dataclasses.replace(cfg, insert_dircache=True)
    # a frame with more first-seen keys than the miss lanes pages once more
    launches["splat+dircache"], state, _ = phase_orbit(
        smi, cached, frames, gts, "splat", None, label="splat+dircache",
        most_reads=2)
    keys, vals = orb.sorted_registry(state)
    same = torch.equal(keys, splat_registry[0]) \
        and torch.equal(vals, splat_registry[1])
    live = int((state.dir_nodes >= 0).sum())
    print(f"[splat+dircache] registry of {keys.numel()} leaves equals the "
          f"uncached orbit's: {same} | directory rows live after the last "
          f"frame: {live} of {state.dir_nodes.numel()}")
    check(same, "[splat+dircache] the cached orbit's registry differs from "
          "the uncached orbit's")
    check(live > 0, "[splat+dircache] the directory is empty")
    del state

    anchored = dataclasses.replace(cfg, track_keyframe=True,
                                   saturation_gate=True)
    launches["splat+keyframe+gate"], state, _ = phase_orbit(
        smi, anchored, frames, gts, "splat", None,
        label="splat+keyframe+gate", pinned=None)
    rebuilt = pipeline.rebuild_sat_mask(state, anchored)
    off = int((rebuilt.sat_mask != state.sat_mask).sum())
    alpha = (state.leaves.vals[:int(state.leaves.count)] >> 24) & 0xFF
    print(f"[splat+keyframe+gate] sat_mask of {state.sat_mask.numel()} words:"
          f" {off} differ from rebuild_sat_mask's, "
          f"{int((state.sat_mask != 0).sum())} non-zero; highest leaf alpha "
          f"{int(alpha.max())}; anchor moved off the first pose: "
          f"{not torch.equal(state.key_pose, gts[0])}")
    check(off == 0, f"[splat+keyframe+gate] {off} mask words differ from "
          "the rebuilt mask")
    check(not torch.equal(state.key_pose, gts[0]),
          "[splat+keyframe+gate] the anchor never moved")
    return launches


def _psnr_db(fb, ref) -> float:
    d = fb[..., :3] - ref[..., :3]
    return 10.0 * float(torch.log10(1.0 / torch.clamp((d ** 2).mean(),
                                                     min=1e-12)))


def phase_fidelity(smi: str, cfg, hybrid_cfg, frames, gts):
    """Phase 9: cone_psnr_db and cone_hybrid_psnr_db as bench.py takes
    them, on a map built in one pass by splat frames, and the idempotence
    of heal_for_march. Returns the two PSNRs."""
    from octree_slam_tpu_torch import convert, pipeline
    state = pipeline.init_state(cfg, initial_pose=gts[0], device="cuda")
    for f in frames[:-1]:
        state, _ = pipeline.step(state, f, cfg, render="splat")
    twin = convert.clone_state(state)
    third = convert.clone_state(state)
    fourth = convert.clone_state(state)
    _, out_cone = pipeline.step(state, frames[-1], cfg, render="cone")
    _, out_march = pipeline.step(twin, frames[-1], cfg, render="cone_march")
    _, out_hyb = pipeline.step(fourth, frames[-1], hybrid_cfg,
                               render="cone_hybrid")
    del state, twin, fourth
    for name, o in (("cone", out_cone), ("cone_march", out_march),
                    ("cone_hybrid", out_hyb)):
        check(bool(torch.isfinite(o.framebuffer).all()),
              f"[fidelity] the {name} image is not finite")
    psnr = _psnr_db(out_cone.framebuffer, out_march.framebuffer)
    hyb_psnr = _psnr_db(out_hyb.framebuffer, out_march.framebuffer)
    print(f"[fidelity] {smi} | " + json.dumps({
        "cone_psnr_db": psnr, "cone_hybrid_psnr_db": hyb_psnr,
        "floor_db": CONE_PSNR_FLOOR_DB,
        "map_leaves": int(out_march.map_leaves),
        "march_lit_pixels": int((out_march.framebuffer[..., :3].sum(-1)
                                 > 0).sum()),
        "cone_lit_pixels": int((out_cone.framebuffer[..., :3].sum(-1)
                                > 0).sum()),
        "hybrid_lit_pixels": int((out_hyb.framebuffer[..., :3].sum(-1)
                                  > 0).sum())}))
    check(psnr >= CONE_PSNR_FLOOR_DB,
          f"[fidelity] cone_psnr_db {psnr:.2f} under {CONE_PSNR_FLOOR_DB}")
    check(hyb_psnr == hyb_psnr and hyb_psnr < float("inf")
          and hyb_psnr > psnr,
          f"[fidelity] cone_hybrid_psnr_db {hyb_psnr:.2f} is not above "
          f"cone_psnr_db {psnr:.2f}")

    check(bool(third.interior_stale) and bool(third.mirror_stale),
          "[fidelity] the splat frames left nothing to heal")
    pool, cache = pipeline.heal_for_march(third, cfg)
    first = [pool.value.clone(), cache.values, cache.occ, cache.dist]
    pool, cache = pipeline.heal_for_march(third._replace(pool=pool), cfg)
    second = [pool.value, cache.values, cache.occ, cache.dist]
    moved = [n for n, a, b in zip(("pool.value", "values", "occ", "dist"),
                                  first, second) if not torch.equal(a, b)]
    print(f"[fidelity] heal_for_march twice: {len(moved)} of 4 buffers "
          f"changed {moved}; occupied dist cells {int(cache.occ.sum())}")
    check(not moved, f"[fidelity] a second heal changed {moved}")
    check(int(cache.occ.sum()) > 0, "[fidelity] the healed mirror is empty")
    return {"cone_psnr_db": psnr, "cone_hybrid_psnr_db": hyb_psnr}


def _profile_frame(smi, state, frames, cfg, frame_ms, render):
    """torch.profiler over the second of three `frames` (the first warms
    the profiler up): host time per step stage, device time per kernel,
    and the CUDA runtime calls (launches, syncs, copies) by host time. The
    device's idle share is taken against `frame_ms`, the frame median
    measured without the profiler, which slows the host. The third frame
    runs with the synchronisation warnings on and counts the host reads."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from octree_slam_tpu_torch import pipeline
    walls, captured = [], []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: captured.append(
                     p.key_averages())) as prof:
        for frame in frames[:2]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = pipeline.step(state, frame, cfg, render=render)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            prof.step()
    check(len(captured) == 1, "the profiler recorded no cycle")
    events = captured[0]
    cuda = torch.autograd.DeviceType.CUDA
    ranges = [e for e in events if e.key.startswith(("ProfilerStep", "step."))]
    kernels = [e for e in events if getattr(e, "device_type", None) == cuda
               and e not in ranges]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    tag = f"[profile {render}]"
    print(f"{tag} {smi} | one frame: device busy {busy:.3f} ms, "
          f"{sum(e.count for e in kernels)} kernels | frame median without "
          f"the profiler {frame_ms:.3f} ms, so the device is idle "
          f"{100 * (1 - busy / frame_ms):.1f}% of it | host wall of the "
          f"profiled frame {walls[-1]:.3f} ms")
    for e in ranges:
        if e.key.startswith("step.") and e.cpu_time_total > 0:
            print(f"{tag}   range {e.key:13s} host "
                  f"{e.cpu_time_total / 1e3:8.3f} ms")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        print(f"{tag}   kernel {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:<5d} {e.key[:80]}")
    for e in sorted((e for e in events if e.key.startswith("cuda")),
                    key=lambda e: e.cpu_time_total, reverse=True)[:8]:
        print(f"{tag}   runtime {e.cpu_time_total / 1e3:8.3f} ms host "
              f"x{e.count:<5d} {e.key}")

    with orb.HostReads() as reads:
        state, _ = pipeline.step(state, frames[2], cfg, render=render)
    print(f"{tag}   host reads that synchronise, one frame: {reads.count}")
    if render == "cone_march":
        print(f"{tag}   march trips: " + json.dumps(_march_trips(state, cfg)))


def phase_tum(smi: str):
    """Phase 10: a 14-frame 640x480 TUM-format sequence written by the
    port, replayed through its CLI (the last JSON line and the trajectory
    file are checked), then timed as bench_configs.config_tum times it:
    slam_fps with the frames staged on the card, and
    e2e_fps_incl_decode_upload through the decoding feeder; the per-array
    ingest (prefetched(packed=False)) yields the packed path's frames."""
    from octree_slam_tpu_torch import SLAMConfig, app
    from octree_slam_tpu_torch.io import tum
    from octree_slam_tpu_torch.sensor import cuda_ops
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        root = tum.write_sequence(os.path.join(d, "seq"), orb.ORBIT_FRAMES,
                                  640, 480, device="cuda")
        t_write = time.perf_counter() - t0
        traj = os.path.join(d, "traj.txt")
        out = io.StringIO()
        torch.cuda.synchronize()
        cuda_ops.reset_launches()
        with contextlib.redirect_stdout(out):
            app.main(["--source", "tum", "--tum-root", root, "--frames",
                      str(orb.ORBIT_FRAMES), "--save-trajectory", traj,
                      "--log-every", "0"])
            torch.cuda.synchronize()
        launches = dict(cuda_ops.LAUNCHES)
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        est = tum._read_groundtruth(traj)

        ds = tum.TUMDataset(root, max_frames=orb.ORBIT_FRAMES, device="cuda")
        _native_check(smi, ds)
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds.decode(i)
        decode_ms = 1e3 * (time.perf_counter() - t0) / len(ds)
        h, w = ds.decode(0)[0].shape
        cfg = SLAMConfig(width=w, height=h, focal_x=ds.FX,
                         focal_y=ds.FY, max_depth=9, voxel_resolution=0.02,
                         node_capacity=1 << 20, leaf_capacity=1 << 17)
        init = ds.gt_pose(0)
        quiet = contextlib.redirect_stdout(io.StringIO())
        with quiet:
            warm = ds.prefetched()
            app.run_slam(lambda i: next(warm), 2, cfg, initial_pose=init,
                         device="cuda")
            warm.close()
            frames = ds.prefetched()
            e2e = app.run_slam(lambda i: next(frames), len(ds), cfg,
                               initial_pose=init, gt_fn=ds.gt_pose,
                               device="cuda")
            staged = [ds.frame(i) for i in range(len(ds))]
            # the reference's per-array upload against the packed one
            per_array = list(ds.prefetched(packed=False))
            packed = list(ds.prefetched())
            per_array_equal = len(per_array) == len(packed) == len(ds) and all(
                torch.equal(a.depth, b.depth) and torch.equal(a.color, b.color)
                and torch.equal(a.timestamp, b.timestamp)
                and torch.equal(a.depth, c.depth)
                for a, b, c in zip(per_array, packed, staged))
            del per_array, packed
            torch.cuda.synchronize()
            res = app.run_slam(lambda i: staged[i], len(ds), cfg,
                               initial_pose=init, gt_fn=ds.gt_pose,
                               device="cuda")
    print(f"[tum] {smi} | " + json.dumps({
        "cli": rec, "trajectory_rows": len(est), "write_s": t_write,
        "png_decode_ms_per_frame": decode_ms,
        "slam_fps": res.fps, "e2e_fps_incl_decode_upload": e2e.fps,
        "ate_rmse_m": res.ate_rmse, "e2e_ate_rmse_m": e2e.ate_rmse,
        "per_array_frames_equal_packed": per_array_equal,
        "launches": launches}))
    check(per_array_equal, "[tum] prefetched(packed=False) yields other "
          "frames than the packed upload")
    check(rec["frames"] == orb.ORBIT_FRAMES and rec["diverged"] is False,
          f"[tum] the CLI run: {rec}")
    check(rec["ate_rmse"] is not None and rec["ate_rmse"] < FEATURE_ATE_MAX_M,
          f"[tum] the CLI run's ATE {rec['ate_rmse']}")
    check(len(est) == orb.ORBIT_FRAMES
          and all(np.isfinite(T).all() for _, T in est),
          "[tum] the trajectory file does not read back")
    check(not res.diverged and not e2e.diverged
          and res.ate_rmse < FEATURE_ATE_MAX_M
          and e2e.ate_rmse < FEATURE_ATE_MAX_M,
          "[tum] the timed runs lost track")
    for name in KERNELS:
        check(launches[name] == orb.ORBIT_FRAMES,
              f"[tum] {name} launches {launches[name]} != {orb.ORBIT_FRAMES}")
    return launches


def phase_entry_points(smi: str, cfg, frames, gts, splat_registry):
    """Phase 11: the orbit through the program's other entry points, each
    with its launch counts, wall time and host reads: app.run_slam (the
    benchmark's loop), the same at capacities small enough to grow, the
    same with the recovery frame blanked and then one attempt alone on the
    recovered state (its launches' batch read from LAUNCH_BATCHES),
    run_slam_2d on the 1 x 8 and 2 x 4 meshes, and the CLI with
    --save-mesh. The `cuda` tests hold these runs' results and launch
    counts (tests/test_torch_cuda_app.py, test_torch_cuda_parallel.py,
    test_torch_cuda_offline.py), so nothing is checked here. Returns
    ({path: launches}, the lone attempt's {kernel: {batch: launches}})."""
    from octree_slam_tpu_torch import relocalize
    from octree_slam_tpu_torch.parallel import distributed
    from octree_slam_tpu_torch.sensor import cuda_ops

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    def slam(path, run_cfg, run_frames):
        (res, state, events, launches[path], batches, reads), wall = timed(
            lambda: orb.run_slam(run_cfg, run_frames, gts))
        rep[path] = {"wall_s": wall, "fps": res.fps,
                     "frame_ms_median": 1e3 / res.steady_fps,
                     "max_frame_s": res.max_frame_s,
                     "diverged": res.diverged,
                     "ate_rmse_m": orb.orbit_ate(res.poses, gts),
                     "events": [e.get("event") for e in events],
                     "host_reads": reads, "launch_batches": batches}
        return res, state

    launches, rep = {}, {}
    slam("app", cfg, frames)
    node_cap, leaf_cap = orb.growth_capacities(splat_registry[0].numpy(),
                                               cfg.max_depth)
    res, _ = slam("grow", dataclasses.replace(
        cfg, node_capacity=node_cap, leaf_capacity=leaf_cap), frames)
    rep["grow"].update(growth_frame_s=res.growth_frame_s, capacities=[
        [node_cap, leaf_cap],
        [res.final_cfg.node_capacity, res.final_cfg.leaf_capacity]])
    rcfg, blanked = orb.recovery(cfg, frames)
    res, state = slam("relocalize", rcfg, blanked)
    keyposes = res.poses[:orb.RELOC_GARBAGE_FRAME:2]
    for _ in range(2):      # the second call, warm, is the one reported
        torch.cuda.synchronize()
        cuda_ops.reset_launches()
        with orb.HostReads() as reads:
            (_, ok, _), wall = timed(
                lambda: relocalize.relocalize(state, rcfg, keyposes))
            torch.cuda.synchronize()
    attempt = {k: dict(v) for k, v in cuda_ops.LAUNCH_BATCHES.items()}
    rep["relocalize"].update(
        relocalizations=res.relocalizations, attempt_ms=1e3 * wall,
        attempt_ok=ok, attempt_host_reads=reads.count,
        attempt_launch_batches=attempt)
    del state
    for path, shape in (("multichip_1x8", (1, 8)), ("multichip", (2, 4))):
        mesh = distributed.make_mesh2(*shape)
        (_, _, info, launches[path]), wall = timed(
            lambda: orb.run_2d(cfg, mesh, frames, gts))
        rep[path] = {"wall_s": wall,
                     "ate_rmse_m": orb.orbit_ate(list(info["poses"]), gts),
                     "events": [e["event"] for e in info["events"]]}
    with tempfile.TemporaryDirectory() as d:
        obj = os.path.join(d, "map.obj")
        (_, rec, launches["offline"]), wall = timed(lambda: orb.run_cli(obj))
        rep["offline"] = {"wall_s": wall, "cli": rec,
                          "obj_mib": os.path.getsize(obj) / 2**20}
    for path, r in rep.items():
        print(f"[entry points] {smi} | {path} "
              + json.dumps({**r, "launches": launches[path]}))
    return launches, attempt


# ------------------------------------------------------------------ [knobs]

# the hybrid's band knobs on [fidelity]'s map, each beside bench.py's band
# (crawl 1 x 24 trips)
BAND_BASE = "crawl=1 x 24"
BAND_KNOBS = {
    "sel_decimate": {"cone_band_sel_decimate": True},
    "depth_prio=0.5": {"cone_band_depth_prio": 0.5},
    "crawl=4 x 6": {"cone_band_crawl": 4, "cone_band_iters": 6},
    "crawl=4 x 24": {"cone_band_crawl": 4},
    "compact_after=8": {"cone_band_compact_after": 8},
    # at 24 trips the live lanes never fit C/4; at 96 they do
    "crawl=1 x 96": {"cone_band_iters": 96},
    "compact_after=8 x 96": {"cone_band_compact_after": 8,
                             "cone_band_iters": 96},
}
# the reference's contract for the crawl (tests/test_hybrid.py:155-195):
# crawl 4 x 8 trips within CRAWL_DB_TOL of crawl 1 x 32 on its scene of six
# hybrid frames at 80x60, depth 7, 4 cm leaves
CRAWL_DB_TOL = 0.3
# the slab cone's composite modes on the same map
SLAB_MODES = {"accumulate": {"accumulate": True},
              "blend=0.25": {"blend": 0.25}, "bilinear": {"bilinear": True}}
# rounds of the renders' timing: each round times every variant once, in
# turns, so that the host's drift falls on all of them alike
KNOB_RENDER_RUNS = 9


def _render_table(renders, ref):
    """{name: PSNR against `ref`, render ms and device operations} of the
    render callables in `renders`: the median of KNOB_RENDER_RUNS rounds of
    CUDA-event times, one call of each variant a round, and the kernels,
    copies and fills of one call as torch.profiler traces them."""
    from torch.profiler import ProfilerActivity, profile
    from octree_slam_tpu_torch.utils.timing import EventTimer
    table = {}
    for name, fn in renders.items():
        fb = fn()
        check(bool(torch.isfinite(fb).all()),
              f"[knobs] {name}: the image is not finite")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        table[name] = {"psnr_db": _psnr_db(fb, ref), "device_ops": sum(
            e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)}
    timer = EventTimer()
    for _ in range(KNOB_RENDER_RUNS):
        for name, fn in renders.items():
            with timer.time(name):
                fn()
    for name in renders:
        table[name]["render_ms"] = statistics.median(timer.ms(name))
    return table


def _crawl_contract(smi):
    """crawl 4 x 8 against crawl 1 x 32 on the reference's scene for that
    contract, each against the exact march; returns the gap in dB."""
    from octree_slam_tpu_torch import SLAMConfig, convert, pipeline
    from octree_slam_tpu_torch.render import hybrid
    from octree_slam_tpu_torch.sensor import sources
    cfg = SLAMConfig(width=80, height=60, focal_x=70.0, focal_y=70.0,
                     pyramid_depth=2, pyramid_iters=(4, 4),
                     voxel_resolution=0.04, max_depth=7,
                     node_capacity=1 << 17, leaf_capacity=1 << 15,
                     max_march_iters=64)
    scene = sources.default_scene("cuda")
    state = pipeline.init_state(
        cfg, initial_pose=sources.orbit_pose(0.0, device="cuda"),
        device="cuda")
    for i in range(6):
        frame = sources.render_frame(
            scene, sources.orbit_pose(i * 0.015, radius=2.0, device="cuda"),
            cfg.focal_x, cfg.focal_y, width=cfg.width, height=cfg.height)
        state, out = pipeline.step(state, frame, cfg, render="cone_hybrid")
    _, march = pipeline.step(convert.clone_state(state), frame, cfg,
                             render="cone_march")
    psnr = {k: _psnr_db(hybrid.render_cone_hybrid(
        state.leaves, state.accel, state.pool.center, state.pool.half_size,
        out.pose, cfg.focal_x, cfg.focal_y, spec=pipeline._slab_spec(cfg),
        depth=cfg.max_depth, dist_level=pipeline._accel_level(cfg),
        band_iters=iters, crawl=k), march.framebuffer)
        for k, iters in ((1, 32), (4, 8))}
    gap = psnr[1] - psnr[4]
    print(f"[knobs] {smi} | the reference's crawl scene (80x60, depth 7): "
          f"crawl 1 x 32 {psnr[1]:.4f} dB, crawl 4 x 8 {psnr[4]:.4f} dB, "
          f"gap {gap:.4f} dB (bound {CRAWL_DB_TOL})")
    check(gap < CRAWL_DB_TOL,
          f"[knobs] crawl 4 x 8 is {gap:.3f} dB below crawl 1 x 32 on the "
          f"reference's scene")
    return gap


def _window_phase(smi, cfg, frames, gts):
    """[knobs] part 1: bilateral_window against its plain version at every
    case; the splat orbit at a WINDOW_SIZE window through step; the 2 x 4
    mesh's row-sharded pyramid at a WINDOW_HALO_SIZE window against the
    whole frame's. Returns (the kernel's report, the orbit's launches)."""
    from octree_slam_tpu_torch.parallel import distributed
    from octree_slam_tpu_torch.sensor import cuda_ops, tracking
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [_kernel_case(WINDOW_KERNEL, shape, k, gen, runs=20)
             for shape, k in WINDOW_CASES]
    # every case's instance and times beside the main path's
    report = dict(cases[0], max_abs_err=max(c["max_abs_err"]
                                            for c in cases), cases=[
        {"shape": list(shape), "kernel_size": k,
         "instance": cuda_ops.bilateral_instance(k),
         **{key: c[key] for key in ("device_ms", "ms", "bound_ms")}}
        for (shape, k), c in zip(WINDOW_CASES, cases)])

    wcfg = dataclasses.replace(cfg, bilateral_kernel_size=WINDOW_SIZE)
    launches, _, _ = phase_orbit(smi, wcfg, frames, gts, "splat", None,
                                 label=f"splat+bilateral{WINDOW_SIZE}",
                                 pinned=WINDOW_ORBIT_PIN)

    hcfg = dataclasses.replace(cfg, bilateral_kernel_size=WINDOW_HALO_SIZE)
    sensor = distributed.row_sharded_sensor(
        hcfg, distributed.make_mesh2(2, 4))
    off, slab_launches = 0, 0
    for f in frames:
        before = cuda_ops.LAUNCHES[WINDOW_KERNEL]
        whole, _ = sensor(f)
        slab_launches += cuda_ops.LAUNCHES[WINDOW_KERNEL] - before
        for a, b in zip(whole, tracking.build_pyramid(f.depth, f.color,
                                                      hcfg)):
            off += sum(int((x != y).sum()) for x, y in zip(a, b))
    print(f"[knobs] mesh (2, 4) at a {WINDOW_HALO_SIZE}x{WINDOW_HALO_SIZE} "
          f"window, halo {distributed.pyramid_halo(hcfg)} rows: slab "
          f"pyramids of {len(frames)} frames, {off} values differ from the "
          f"whole frame's; {slab_launches} {WINDOW_KERNEL} launches")
    check(off == 0, f"[knobs] {off} slab pyramid values differ at "
          f"kernel_size {WINDOW_HALO_SIZE}")
    check(slab_launches == 2 * len(frames),
          f"[knobs] {slab_launches} slab launches, expected 2 a frame")
    return report, launches


def phase_knobs(smi: str, cfg, hybrid_cfg, frames, gts, fidelity):
    """Phase 12: what the reference runs beyond the defaults, at full width.
    The bilateral of other window sizes (_window_phase); then on [fidelity]'s
    map the hybrid's band knobs, each through step("cone_hybrid"), and the
    slab cone's modes, each with its PSNR against the exact march, its
    render time (CUDA events) and its device operations a render. The
    compacting march must give the fixed-trip image bit for bit, the base
    hybrid and the default slab mode must keep [fidelity]'s PSNRs, and the
    crawl must keep the reference's contract on the reference's scene
    (_crawl_contract); its gap at full width is printed. Returns
    (bilateral_window's report, the 5x5 orbit's launches)."""
    from octree_slam_tpu_torch import convert, pipeline
    from octree_slam_tpu_torch.render import conesplat, hybrid
    t_phase = time.perf_counter()
    report, launches = _window_phase(smi, cfg, frames, gts)

    # [fidelity]'s map: 13 splat frames, the last frame by each render
    state = pipeline.init_state(cfg, initial_pose=gts[0], device="cuda")
    for f in frames[:-1]:
        state, _ = pipeline.step(state, f, cfg, render="splat")
    _, march = pipeline.step(convert.clone_state(state), frames[-1], cfg,
                             render="cone_march")
    ref = march.framebuffer
    lvl = pipeline._accel_level(cfg)
    renders, images = {}, {}
    for name, change in {BAND_BASE: {}, **BAND_KNOBS}.items():
        kcfg = dataclasses.replace(hybrid_cfg, **change)
        st, out = pipeline.step(convert.clone_state(state), frames[-1], kcfg,
                                render="cone_hybrid")

        def render(st=st, kcfg=kcfg, pose=out.pose, debug=False):
            return hybrid.render_cone_hybrid(
                st.leaves, st.accel, st.pool.center, st.pool.half_size, pose,
                kcfg.focal_x, kcfg.focal_y, spec=pipeline._slab_spec(kcfg),
                depth=kcfg.max_depth, dist_level=lvl,
                max_range=kcfg.max_range, start_dist=kcfg.start_dist,
                band_cap=kcfg.cone_band_cap, band_iters=kcfg.cone_band_iters,
                crawl=kcfg.cone_band_crawl,
                fused_dist=kcfg.cone_band_fused_dist,
                depth_prio=kcfg.cone_band_depth_prio,
                compact_after=kcfg.cone_band_compact_after,
                sel_decimate=kcfg.cone_band_sel_decimate, debug_band=debug)

        check(torch.equal(render(), out.framebuffer),
              f"[knobs] {name}: the timed render is not the step's")
        renders[name], images[name] = render, out.framebuffer
    band = _render_table(renders, ref)
    for name, fb in images.items():
        band[name]["pixels_differing_from_base"] = int(
            (fb != images[BAND_BASE]).any(-1).sum())
    packed_at = renders["compact_after=8 x 96"](debug=True)[1]["packed_at"]
    long_off = int((images["compact_after=8 x 96"].view(torch.int32)
                    != images["crawl=1 x 96"].view(torch.int32)).sum())
    del renders, images
    print(f"[knobs] {smi} | hybrid band knobs, {orb.HYBRID_BAND} unless "
          f"named: " + json.dumps(band))
    print(f"[knobs] compact_after=8 x 96 packs its live lanes into "
          f"{max(128, orb.HYBRID_BAND['cone_band_cap'] // 4)} after trip "
          f"{packed_at}; {long_off} framebuffer words differ from the "
          f"fixed-trip crawl=1 x 96")
    check(packed_at > 0, "[knobs] the 96-trip band march never packed")
    check(long_off == 0, "[knobs] the packed band march's image is not the "
          "fixed-trip one")
    check(abs(band[BAND_BASE]["psnr_db"] - fidelity["cone_hybrid_psnr_db"])
          < 0.01, "[knobs] the base hybrid's PSNR moved from [fidelity]'s")
    check(band["compact_after=8"]["pixels_differing_from_base"] == 0,
          "[knobs] the compacting march's image is not the fixed-trip one")
    crawl_gap = band[BAND_BASE]["psnr_db"] - band["crawl=4 x 6"]["psnr_db"]
    print(f"[knobs] crawl 4 x 6 against crawl 1 x 24 at full width: "
          f"{crawl_gap:.4f} dB below")
    _crawl_contract(smi)

    st, out = pipeline.step(convert.clone_state(state), frames[-1], cfg,
                            render="cone")
    del state

    def slab(**kw):
        return conesplat.render_cone_splat(
            st.leaves, st.pool.center, st.pool.half_size, out.pose,
            cfg.focal_x, cfg.focal_y, spec=pipeline._slab_spec(cfg),
            depth=cfg.max_depth, **kw)

    check(torch.equal(slab(), out.framebuffer),
          "[knobs] the default slab render is not the step's")
    modes = _render_table({name: functools.partial(slab, **kw) for name, kw
                           in {"min": {}, **SLAB_MODES}.items()}, ref)
    print(f"[knobs] {smi} | slab cone modes: " + json.dumps(modes))
    check(abs(modes["min"]["psnr_db"] - fidelity["cone_psnr_db"]) < 0.01,
          "[knobs] the default slab mode's PSNR moved from [fidelity]'s")
    print(f"[knobs] phase wall {time.perf_counter() - t_phase:.1f} s")
    return report, launches


def _native_check(smi: str, ds):
    """The [native] lines: whether the native runtime built (and if not,
    the compiler's first error line), which PNG decoder the TUM reader
    took, and where it built, its decode of the sequence's files against
    the pure decoder byte for byte, with the decode ms a frame of each."""
    from octree_slam_tpu_torch.io import native, png
    avail = native.available()
    rep = {"available": avail, "build_error": native.BUILD_ERROR,
           "tum_decode_path": "native libpng" if avail else "pure io/png.py"}
    if avail:
        files = [os.path.join(ds.root, name) for pair in ds.pairs
                 for _, name in pair]
        t0 = time.perf_counter()
        got = [native.read_png(f) for f in files]
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = [png.read_png(f) for f in files]
        t_pure = time.perf_counter() - t0
        rep.update(
            files=len(files),
            differing_files=sum(
                a.dtype != b.dtype or a.shape != b.shape
                or not np.array_equal(a, b) for a, b in zip(got, want)),
            native_decode_ms_per_frame=1e3 * t_native / len(ds.pairs),
            pure_decode_ms_per_frame=1e3 * t_pure / len(ds.pairs))
    print(f"[native] {smi} | " + json.dumps(rep))
    if avail:
        check(rep["differing_files"] == 0,
              f"[native] {rep['differing_files']} PNGs decode otherwise "
              f"than the pure decoder")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", nargs="?", const="splat", default=None,
                    choices=("splat", "cone", "cone_march", "cone_hybrid"),
                    help="profile one extra frame of this render by kernel "
                         "(torch.profiler) and count its host reads")
    args = ap.parse_args(argv)
    smi = phase_device()
    phase_build()
    report = phase_kernels()
    cfg = orb.bench_config()
    splat_rows = phase_splat(smi, cfg)
    frames, gts = orb.orbit(cfg)
    launches = {}
    launches["splat"], state, splat_res = phase_orbit(
        smi, cfg, frames, gts, "splat", args.profile)
    splat_registry = orb.sorted_registry(state)
    del state
    hybrid_cfg = dataclasses.replace(cfg, **orb.HYBRID_BAND)
    for render in ("cone", "cone_march", "cone_hybrid"):
        launches[render], _, hybrid_res = phase_orbit(
            smi, hybrid_cfg if render == "cone_hybrid" else cfg, frames, gts,
            render, args.profile)
    launches.update(phase_features(smi, cfg, frames, gts, splat_registry))
    fidelity = phase_fidelity(smi, cfg, hybrid_cfg, frames, gts)
    launches["tum"] = phase_tum(smi)
    paths, attempt = phase_entry_points(smi, cfg, frames, gts,
                                        splat_registry)
    launches.update(paths)
    window = f"splat+bilateral{WINDOW_SIZE}"
    report[WINDOW_KERNEL], launches[window] = phase_knobs(
        smi, cfg, hybrid_cfg, frames, gts, fidelity)
    # each kernel's main path: the splat orbit at the window that runs it
    main_path = {name: "splat" for name in KERNELS}
    main_path[WINDOW_KERNEL] = window
    replaces = {name: spec["replaces"] for name, spec in KERNELS.items()}
    replaces[WINDOW_KERNEL] = WINDOW_REPLACES
    # no single PyTorch call computes any of them, so library_ms is null
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": replaces[name], "main_path": path,
                "launches": launches[path][name],
                "launches_per_frame": launches[path][name] / orb.ORBIT_FRAMES,
                "launches_by_path": {p: n.get(name, 0)
                                     for p, n in launches.items()},
                # the largest batch of a lone recovery attempt's launches
                # (the candidates scored as one), None where none launched
                "relocalize_launch_batch": max(attempt.get(name, {}),
                                               default=None),
                **report[name]} for name, path in main_path.items()]
    kernels.append({"name": "band_march", "route": "cuda",
                    "source": BAND_SOURCE, "replaces": BAND_REPLACES,
                    "main_path": "cone_hybrid",
                    "launches": hybrid_res["band_launches"],
                    "launches_per_frame": hybrid_res["band_launches"]
                    / orb.ORBIT_FRAMES, **hybrid_res["band_march"]})
    kernels.append({"name": "splat_zbuffer", "route": "cuda",
                    "source": SPLAT_SOURCE, "replaces": SPLAT_REPLACES,
                    "main_path": "splat",
                    "launches": splat_res["splat_launches"],
                    "launches_per_frame": splat_res["splat_launches"]
                    / orb.ORBIT_FRAMES,
                    **splat_rows[SPLAT_LEAVES[-1]],
                    "by_live_leaves": splat_rows})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
