"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the whole check, one card
    python3 chip_smoke.py --profile    # also profile one splat frame by kernel
    python3 chip_smoke.py --profile cone         # ... one slab-cone frame
    python3 chip_smoke.py --profile cone_march   # ... one exact-march frame
    python3 chip_smoke.py --profile cone_hybrid  # ... one hybrid frame
    python3 chip_smoke.py --profile offline      # ... the offline calls

Phases, each of which raises on failure (non-zero exit, no result line):
  1. device: a CUDA card of compute capability 9.0, strict float32 matmuls;
  2. build: compile the port's kernels from octree_slam_tpu_torch/csrc;
  3. kernel vs plain: each hand-written kernel against its plain PyTorch
     version on the card, bit for bit, with both times: per call including
     the launch (CUDA events, median of 50) and on the device alone
     (50 calls replayed from a CUDA graph, their mean), beside the kernel's bound (the larger of
     its bytes over 3.35 TB/s and its float32 operations over 67 TFLOP/s,
     from the shapes of the inputs) and its share of that bound;
  4. main path: the 14-frame synthetic orbit of bench.py (640x480, depth 9,
     2 cm leaves) through pipeline.init_state + pipeline.step("splat"),
     with per-frame CUDA-event times and launch counts, and the ATE and
     map size held to the orbit's known values;
  5. reference: a small stream through the same step on the card and on
     the CPU (the plain versions the CPU tests hold against the JAX
     package) must agree, and so must the slab-cone, exact-march and
     hybrid renders of its last frame, their dense mirror and their slab
     word buffer; the hybrid with each band knob and the slab cone in
     each composite mode (its accumulate sums equal); then a stream with
     the keyframe anchor, the saturation gate and the directory cache on,
     rendered by the hybrid, on both;
  6. the slab cone at full width: the same orbit through step("cone");
  7. the exact march at full width: the same orbit through
     step("cone_march"), every frame eager, with the march's trip counts
     and the peak device memory; then the last frame's march with its
     live-ray compaction (76,800 of 307,200 lanes) against the all-lanes
     march, in turns: equal word for word, with both CUDA-event times and
     both calls' launches and device time;
  8. the hybrid at full width: the same orbit through step("cone_hybrid")
     with bench.py's band (57,600 lanes, 24 trips), every frame lazy; at
     most 3 host reads a frame; afterwards the mirror it kept must equal,
     word for word, one rebuilt from the pool and stamped; the band's size,
     the share of its rays still active at the trip cap and the peak
     device memory are printed; the band's trips run as the kernel
     band_march, one launch a frame; on the last frame the kernel's
     outputs and live lane-trips must equal the eager loop's word for
     word, and its row gives both paths' per-call and device ms, its byte
     bound (each gather one 32-byte sector, over 3.35 TB/s) and launches;
  9. the step features at full width: the splat orbit with the insert's
     directory cache on must end with the splat orbit's leaf registry,
     node count and ATE; the orbit with the keyframe anchor and the
     saturation gate on must not diverge, keep its ATE under 0.01 m and
     end with the mask that rebuild_sat_mask makes;
 10. fidelity, as bench.py measures it: a map built by 13 splat frames,
     the last frame rendered by the slab cone, the exact march and the
     hybrid from copies of the state, and the two PSNRs against the march
     (cone_psnr_db, cone_hybrid_psnr_db: the hybrid's must be the higher);
     then that heal_for_march is idempotent;
 11. app: the same orbit through app.run_slam, the loop a user runs, held
     to the pinned ATE, nodes and leaves, with its frame median beside the
     bare step loop's and its host reads a frame;
 12. checkpoint: save_state of that run's final state writes the JAX
     package's file (n, the arrays a0 .. a{n-1}, the 15 stamps);
     load_state brings back every field word for word, and one more frame
     from the loaded state and from a copy of the original alike; the
     reference's legacy files: without the prealloc stamp (accepted or
     refused as the legacy schedule says), and, on the orbit with the
     directory cache and the saturation gate, a file short of its last 6
     arrays (the directory reset, the mask rebuilt from the registry);
 13. tiering at full size: the final state's leaves spilled to host RAM
     with the camera far away and restored with it back, the leaf words
     and every ancestor's refreshed word unchanged;
 14. grow: the orbit through run_slam with a pool and a registry small
     enough that each doubles (the pool across a prealloc boundary),
     ending with no overflow, a registry equal to an extraction of the
     pool and the pinned ATE;
 15. relocalize: the orbit with frame 8 blanked, recovered by relocalize
     (one bilateral and one gated-pyramid launch over the four candidates
     per attempt);
 16. tum: a 14-frame 640x480 TUM-format sequence written by the port and
     replayed through its CLI, with slam_fps (frames staged on the card)
     and e2e_fps_incl_decode_upload (decoded and uploaded by the feeder),
     and the per-array ingest (prefetched(packed=False)) equal to it;
     [native]: whether the native host I/O runtime (io/native.py) built,
     which PNG decoder the TUM reader took, and the native decode of the
     sequence's files against the pure decoder, byte for byte;
 17. multichip: the orbit through parallel.run2d.run_slam_2d on the 2-D
     ("px", "map") mesh, every shard on the card's one device: the map
     axis alone (1 x 8) equal to the splat orbit bit for bit (poses,
     union of the shards' leaves, packed z-buffer); two row slabs (2 x 4)
     for splat, cone and hybrid, each frame's slab pyramid equal to the
     whole frame's, poses within 1e-5 and the ATE within 1e-5 m of the
     pinned one, two launches of each kernel a frame, the renders against
     the single-device renderer on the same leaves (the splat's packed
     z-buffer and image, the cone's slab words bit for bit); a run that grows and
     rebalances, equal to one pool fed its poses; the sharded tiering
     round trip; the checkpoint round trip in the JAX package's file (its
     13 stamps), every word, every shard on its device and the next
     frame alike; a recovery with frame 8 blanked;
 18. offline, at the reference's full size: an in-code mesh of 100,000
     triangles with a 256x256 texture, written and read back through the
     port's OBJ and BMP code and Scene; the 256^3 voxel grid twice (equal
     word for word), its occupied set against the A-buffer's, THIN inside
     CONSERVATIVE; a reduced mesh card against CPU (grid, A-buffer and a
     rasterization of its voxel cubes, whose faces tie in depth, word for
     word); the grid into the octree with a 640x480 cone trace, a 640x480
     textured rasterization, the voxel view as splats and as cubes; and
     the CLI's --save-mesh after the orbit (8 vertices and 12 faces a
     leaf); a 16-colour palette PNG read by the port's codec (which needs
     no PIL; whether PIL is installed is printed) voxelizes as the same
     texture stored as RGB8.
     These paths reach no hand kernel; only the CLI's orbit launches the
     two stencils;
 19. knobs: bilateral_window, the bilateral of any window size, against
     its plain version: each compiled radius (sizes 3, 5, 9, 11, 13) on
     the main path's frame, sizes 5 and 11 on a ragged frame and the
     recovery batch, and the run-time-radius kernel at size 15, each line
     naming the instance that ran; the orbit through step("splat") at a
     5x5 window (bilateral_window's main path) held to its pinned ATE,
     nodes and leaves; the 2 x 4 mesh's row slabs at an 11x11 window,
     each slab's pyramid equal to the whole frame's; on
     phase 10's map the hybrid with each band knob (sel_decimate,
     depth_prio 0.5, crawl 4 at 6 and at 24 trips, compact_after 8, 96
     trips fixed and compacting after 8) and
     the slab cone in each mode (accumulate, blend 0.25, bilinear), each
     with its PSNR against the exact march, render ms and device
     operations; compact_after 8 gives the fixed-trip image bit for bit,
     and at 96 trips it packs its live lanes and still does;
     the crawl keeps the reference's contract (4 x 8 within 0.3 dB of
     1 x 32) on the reference's own 80x60 scene, and its gap at full
     width (4 x 6 against 1 x 24) is printed;
 20. fuzz_map: tests/test_fuzz_map.py's interplay of insert (paged on
     last_key), insert_exact, grow_capacity and reroot_double at a run's
     size (FUZZ_SPEC: depth 9 at 2 cm, 307,200-point inserts paging at
     65,536 uniques, a pool grown from 2^20 nodes, one re-root to depth
     10), the same ops on the card and on the CPU: after every round the
     two pools equal word for word, and at the end their refreshed
     interiors and extract_all_leaves too, with each op's ms on the card.
Every orbit starts with the kernels' launch counts at 0 and must find each
kernel of its path launched once per frame and the others never (plus one
batched launch per recovery attempt), or once per row slab and frame on
the 2-D mesh. The last lines are the card's name and
power limit, a JSON line of the kernels, and {"ok": true, "device":
{...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import re
import statistics
import subprocess
import tempfile
import time
import warnings

import numpy as np
import torch

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
# the H100 SXM's published peaks (NVIDIA data sheet, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# the 14-frame orbit's result since PR 1; the kernels are bit-exact against
# their plain versions, so any change in it is a fault
ORBIT_ATE_M, ORBIT_ATE_TOL_M = 0.0018455, 1e-7
ORBIT_MAP_NODES, ORBIT_MAP_LEAVES = 425_760, 73_458
ORBIT_PIN = (ORBIT_ATE_M, ORBIT_MAP_NODES, ORBIT_MAP_LEAVES)
# the same orbit at a WINDOW_SIZE window (bilateral_window is bit-exact
# against its plain version too): ATE (tolerance ORBIT_ATE_TOL_M), nodes,
# leaves
WINDOW_ORBIT_PIN = (0.0018001, 425_920, 74_050)
ORBIT_FRAMES, ORBIT_WARMUP = 14, 2
# the slab cone against the exact march on one map, in dB
CONE_PSNR_FLOOR_DB = 25.0
# bench.py's hybrid arm: the band's lanes and its trip cap
HYBRID_BAND = {"cone_band_cap": 57_600, "cone_band_iters": 24}
# a feature orbit's own trajectory bound (the verify skill's good output)
FEATURE_ATE_MAX_M = 0.01
# rounds of the exact march's timing, compacted and all lanes in turns
MARCH_COMPACTION_RUNS = 9
# the recovery pyramid's batch: the config's reloc_candidates
RELOC_CANDIDATES = 4
# the relocalize phase's blanked frame, and its bound on the last frame's
# translation error (the reference package's test)
RELOC_GARBAGE_FRAME, RELOC_ERR_MAX_M = 8, 0.05
# [fuzz_map]: tests/test_fuzz_map.py's op interplay at a run's size: depth
# 9 at 2 cm leaves (half size 5.12 m), inserts of a 640x480 frame's 307,200
# points on a plane patch of 6 x 4.4 m at insert_unique_cap 65,536 (about
# 100,000 distinct leaves, so that they page),
# exact writes of up to 60,000 keys, a pool that ensure_headroom's rule
# grows from 2^20 nodes, one reroot_double to depth 10; the ops of each
# round in FUZZ_ROUNDS, their data drawn from FUZZ_SEED
FUZZ_SPEC = dict(depth=9, capacity=1 << 20, half_size=5.12,
                 unique_cap=65_536, insert_n=(307_200, 307_201),
                 exact_n=(40_000, 60_000), max_capacity=1 << 24,
                 max_reroots=1, max_depth=10, surface=True)
FUZZ_ROUNDS = ("insert", "exact", "insert", "grow", "reroot", "insert",
               "exact", "insert")
FUZZ_SEED = 0



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


def _window_taps(n: int, half: int, step: int) -> int:
    """In-image taps along one axis of a (2 half + 1)-wide window centred
    on every `step`-th pixel of an n-pixel axis (whose output has n // step
    pixels when step > 1)."""
    centres = range(0, step * (n // step), step) if step > 1 else range(n)
    return sum(1 for c in centres for d in range(-half, half + 1)
               if 0 <= c + d < n)


def bilateral_work(shape, kernel_size: int = 7):
    """(bytes, float32 operations) of one bilateral call over the window
    of radius kernel_size // 2: the input read and the output written once;
    per in-image tap a subtract, two multiplies, an add, the exp, a
    multiply and two adds (8), and a divide and a round per pixel."""
    b, h, w = (1, *shape) if len(shape) == 2 else shape
    half = kernel_size // 2
    taps = b * _window_taps(h, half, 1) * _window_taps(w, half, 1)
    return 8 * b * h * w, 8 * taps + 2 * b * h * w


def gated_pyramid_work(shape, levels):
    """(bytes, float32 operations) of one gated_pyramid5x5 call: the input
    read and every level written once; per in-image tap of a kept pixel a
    subtract, an abs, a compare and the two adds of a passing tap (every
    tap counted as passing: at most 5, data-dependent below that, and the
    bound stays set by the bytes either way), and a divide per output."""
    b, h, w = (1, *shape) if len(shape) == 2 else shape
    nbytes, ops = 4 * b * h * w, 0
    for _ in range(levels):
        taps = b * _window_taps(h, 2, 2) * _window_taps(w, 2, 2)
        h, w = h // 2, w // 2
        nbytes += 4 * b * h * w
        ops += 5 * taps + b * h * w
    return nbytes, ops


def bound(nbytes: int, ops: int):
    """The least time the card could take: (ms, what sets it)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    bms, by = bound(*work(shape))
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


def _bench_config():
    from octree_slam_tpu_torch import SLAMConfig
    # bench.py's headline configuration
    return SLAMConfig(width=640, height=480, max_depth=9,
                      voxel_resolution=0.02, node_capacity=1 << 20,
                      leaf_capacity=1 << 17)


def _orbit(cfg, n, step_angle, device):
    from octree_slam_tpu_torch.sensor import sources
    scene = sources.default_scene(device)
    gts = [sources.orbit_pose(i * step_angle, radius=2.0, device=device)
           for i in range(n)]
    frames = [sources.render_frame(scene, g, cfg.focal_x, cfg.focal_y,
                                   width=cfg.width, height=cfg.height)
              for g in gts]
    return frames, gts


class _HostReads:
    """Counts the host reads that synchronise with the card while it is
    entered (torch's synchronisation warnings, a prototype that may miss
    some)."""

    def __enter__(self):
        # first, outside the record: switching the mode on warns that it
        # is a prototype
        torch.cuda.set_sync_debug_mode("warn")
        self._catch = warnings.catch_warnings(record=True)
        self._caught = self._catch.__enter__()
        warnings.simplefilter("always")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
        self.count = sum("synchroniz" in str(w.message)
                         for w in self._caught)


def _drive_orbit(cfg, frames, gts, render: str, label: str):
    """The orbit through init_state + step(render) with the kernels'
    launch counts set to 0 just before and read just after; per-frame
    CUDA-event times of the frames after the warm-up, and the last frame's
    count of synchronising host reads."""
    from octree_slam_tpu_torch import pipeline
    from octree_slam_tpu_torch.render import band_ops
    from octree_slam_tpu_torch.sensor import cuda_ops
    from octree_slam_tpu_torch.utils.metrics import ate_rmse
    from octree_slam_tpu_torch.utils.timing import EventTimer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    band_ops.reset_launches()
    t0 = time.perf_counter()
    state = pipeline.init_state(cfg, initial_pose=gts[0], device="cuda")
    sizes = []
    for i in range(ORBIT_WARMUP):
        state, out = pipeline.step(state, frames[i], cfg, render=render)
        sizes.append(torch.stack([out.map_nodes, out.map_leaves]))
    timer = EventTimer()
    est, host_ms = [], []
    for i in range(ORBIT_WARMUP, len(frames) - 1):
        t1 = time.perf_counter()
        with timer.time("frame"):
            state, out = pipeline.step(state, frames[i], cfg, render=render)
        host_ms.append(1e3 * (time.perf_counter() - t1))
        est.append(out.pose)
        sizes.append(torch.stack([out.map_nodes, out.map_leaves]))
    with _HostReads() as reads, timer.time("frame"):
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
            np.stack([g.cpu().numpy() for g in gts[ORBIT_WARMUP:]])),
        "map_nodes": int(out.map_nodes), "map_leaves": int(out.map_leaves),
        "diverged": bool(out.diverged),
        "map_overflowed": bool(out.map_overflowed),
        "fb_hit_pixels": int((fb[..., :3].sum(-1) > 0).sum()),
        "launches": launches, "host_reads_last_frame": reads.count,
        "band_launches": band_ops.LAUNCHES[band_ops.KERNEL],
        # (nodes, leaves) after each frame, read once after the run
        "map_size_by_frame": sizes,
        "wall_s_with_warmup": wall,
        "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20,
    }
    return state, out, res


def _check_orbit(smi: str, cfg, out, res, n_frames: int, pinned):
    """The checks every orbit must pass, whatever its render. `pinned`,
    (ATE, nodes, leaves), holds the trajectory and the map to an orbit's
    known values (the ATE within ORBIT_ATE_TOL_M); an orbit that tracks
    another way (the keyframe anchor), with `pinned` None, has its own
    trajectory and is held to FEATURE_ATE_MAX_M."""
    tag = f"[{res['path']}]"
    print(f"{tag} {smi} | 640x480 depth 9 2 cm, {n_frames - ORBIT_WARMUP} "
          f"timed frames after {ORBIT_WARMUP} warm-up | frame ms median "
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
        check(abs(res["ate_rmse_m"] - ate) <= ORBIT_ATE_TOL_M,
              f"{tag} ATE {res['ate_rmse_m']:.9f} m, expected {ate} "
              f"+- {ORBIT_ATE_TOL_M} m")
        check(res["map_nodes"] == nodes,
              f"{tag} map nodes {res['map_nodes']}, expected {nodes}")
        check(res["map_leaves"] == leaves,
              f"{tag} map leaves {res['map_leaves']}, expected {leaves}")
    else:
        check(res["ate_rmse_m"] < FEATURE_ATE_MAX_M,
              f"{tag} ATE {res['ate_rmse_m']:.6f} m, expected under "
              f"{FEATURE_ATE_MAX_M} m")
        check(res["map_leaves"] > ORBIT_MAP_LEAVES // 2,
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
    check(lanes == HYBRID_BAND["cone_band_cap"], f"band of {lanes} lanes")
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
    bms, by = bound(nbytes, 0)
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


def _sorted_registry(state):
    """The leaf registry sorted by key, on the host: (keys, words)."""
    n = int(state.leaves.count)
    keys, order = torch.sort(state.leaves.keys[:n])
    return keys.cpu(), state.leaves.vals[:n][order].cpu()


def phase_features(smi: str, cfg, frames, gts, splat_registry):
    """Phase 9: the orbit with the insert's directory cache, held to the
    splat orbit's map; the orbit with the keyframe anchor and the
    saturation gate, held to its own ATE bound and to the rebuilt mask."""
    from octree_slam_tpu_torch import pipeline
    launches = {}
    cached = dataclasses.replace(cfg, insert_dircache=True)
    # a frame with more first-seen keys than the miss lanes pages once more
    launches["splat+dircache"], state, _ = phase_orbit(
        smi, cached, frames, gts, "splat", None, label="splat+dircache",
        most_reads=2)
    keys, vals = _sorted_registry(state)
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
    """Phase 10: cone_psnr_db and cone_hybrid_psnr_db as bench.py takes
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

    with _HostReads() as reads:
        state, _ = pipeline.step(state, frames[2], cfg, render=render)
    print(f"{tag}   host reads that synchronise, one frame: {reads.count}")
    if render == "cone_march":
        print(f"{tag}   march trips: " + json.dumps(_march_trips(state, cfg)))


def _differing(name, a, b, limit=0.01):
    """Count and name the cells where the card's tensor `a` and the CPU's
    `b` differ; more than `limit` of them is a failure."""
    a = a.cpu()
    diff = torch.nonzero((a != b).reshape(-1)).reshape(-1)
    print(f"[reference]   {name}: {diff.numel()} of {a.numel()} cells differ"
          + (f", first at {diff[:8].tolist()}" if diff.numel() else ""))
    check(diff.numel() <= limit * a.numel(),
          f"[reference] {name}: {diff.numel()} of {a.numel()} cells differ")


def _pixels_equal(a, b) -> float:
    """Share of pixels equal as 8-bit colours. The march's colours often
    sit exactly on a rounding tie (x.5 of an 8-bit level), where the two
    devices' last ulp decides the rounding, so a pixel within 1e-4 as
    floats (0.03 of a level) counts as equal too."""
    a = a.cpu()
    same = (torch.round(a * 255) == torch.round(b * 255)) \
        | ((a - b).abs() <= 1e-4)
    return float(same.all(-1).float().mean())


def phase_reference():
    """The same small stream through step on the card and on the CPU, then
    its last frame again through the slab cone, the exact march and the
    hybrid from copies of both states, the hybrid with each band knob and
    the slab cone in each mode, then the stream once more with the
    keyframe anchor, the saturation gate and the directory cache on."""
    from octree_slam_tpu_torch import convert, pipeline
    from octree_slam_tpu_torch.map import mips
    from octree_slam_tpu_torch.render import conesplat
    cfg = dataclasses.replace(
        _bench_config(), width=64, height=48, focal_x=55.0, focal_y=55.0,
        pyramid_depth=2, pyramid_iters=(6, 6), voxel_resolution=0.05,
        max_depth=6, node_capacity=1 << 14, leaf_capacity=1 << 12,
        insert_unique_cap=1 << 10, max_march_iters=48)
    frames, gts = _orbit(cfg, 4, 0.015, "cpu")
    outs, states, last = {}, {}, {}
    for dev in ("cuda", "cpu"):
        state = pipeline.init_state(cfg, initial_pose=gts[0], device=dev)
        for f in frames:
            f = type(f)(*(x.to(dev) for x in f))
            before = convert.clone_state(state)
            state, out = pipeline.step(state, f, cfg)
        outs[dev], states[dev], last[dev] = out, before, f
    g, c = outs["cuda"], outs["cpu"]
    dpose = float((g.pose.cpu() - c.pose).abs().max())
    same = _pixels_equal(g.framebuffer, c.framebuffer)
    print(f"[reference] 64x48 depth 6, 4 frames, card vs CPU: max|d pose| "
          f"{dpose:.2e}, nodes {int(g.map_nodes)} / {int(c.map_nodes)}, "
          f"leaves {int(g.map_leaves)} / {int(c.map_leaves)}, "
          f"framebuffer pixels equal {same:.4f}")
    check(dpose < 1e-4, "card and CPU poses differ")
    for name in ("map_nodes", "map_leaves"):
        a, b = int(getattr(g, name)), int(getattr(c, name))
        check(abs(a - b) <= 0.01 * b, f"{name}: card {a} vs CPU {b}")
    check(same >= 0.99, f"only {same:.4f} of framebuffer pixels agree")
    check(bool(g.diverged) == bool(c.diverged) is False, "diverged")

    # the last frame again, from the state before it, by the new renders
    spec = conesplat.make_slab_spec(
        width=cfg.width, height=cfg.height, fx=cfg.focal_x,
        leaf_size=cfg.voxel_resolution, z_near=cfg.cone_znear,
        z_far=cfg.max_range, n_slabs=cfg.cone_slabs,
        max_scale=cfg.cone_max_scale)
    for render in ("cone", "cone_march", "cone_hybrid"):
        st, fb = {}, {}
        for dev in ("cuda", "cpu"):
            st[dev], out = pipeline.step(convert.clone_state(states[dev]),
                                         last[dev], cfg, render=render)
            fb[dev] = out.framebuffer
            check(bool(torch.isfinite(out.framebuffer).all()),
                  f"[reference] {render} image on {dev} is not finite")
        same = _pixels_equal(fb["cuda"], fb["cpu"])
        print(f"[reference] {render}: framebuffer pixels equal {same:.4f}, "
              f"lit {int((fb['cuda'][..., :3].sum(-1) > 0).sum())} / "
              f"{int((fb['cpu'][..., :3].sum(-1) > 0).sum())}")
        check(same >= 0.99, f"[reference] {render}: only {same:.4f} of "
              f"framebuffer pixels agree")
        if render == "cone":
            cone_st = dict(st)
            bufs = []
            for dev in ("cuda", "cpu"):
                lv = st[dev].leaves
                live = (torch.arange(lv.keys.shape[0], device=dev)
                        < lv.count) & (lv.keys >= 0)
                bufs.append(conesplat.slab_scatter_min(
                    lv.vals, lv.keys, live, st[dev].pool.center,
                    st[dev].pool.half_size, st[dev].pose, cfg.focal_x,
                    cfg.focal_y, spec=spec, depth=cfg.max_depth))
            check(int((bufs[1] != conesplat.EMPTY).sum()) > 0,
                  "[reference] the slab word buffer is empty")
            _differing("slab word buffer", *bufs)
        else:
            # the march keeps the whole mirror, the hybrid its leaf level
            lo = (mips.level_offset(cfg.max_depth)
                  if render == "cone_hybrid" else 0)
            _differing(f"{render} mirror values from cell {lo}",
                       st["cuda"].accel.values[lo:],
                       st["cpu"].accel.values[lo:],
                       limit=0.0 if render == "cone_hybrid" else 0.01)
            for name in ("occ", "dist"):
                _differing(f"{render} mirror {name}",
                           getattr(st["cuda"].accel, name),
                           getattr(st["cpu"].accel, name))
            check(int(st["cpu"].accel.occ.sum()) > 0,
                  "[reference] the mirror is empty")

    # the hybrid's band knobs from the same states, and the slab cone's
    # modes on the cone frame's registry: the accumulate sums are integers
    # below 2^24, exact in any order, so they must be equal
    for name, change in BAND_KNOBS.items():
        kcfg = dataclasses.replace(cfg, **change)
        fb = {dev: pipeline.step(convert.clone_state(states[dev]), last[dev],
                                 kcfg, render="cone_hybrid")[1].framebuffer
              for dev in ("cuda", "cpu")}
        same = _pixels_equal(fb["cuda"], fb["cpu"])
        print(f"[reference] hybrid {name}: framebuffer pixels equal "
              f"{same:.4f}")
        check(bool(torch.isfinite(fb["cuda"]).all()) and same >= 0.99,
              f"[reference] hybrid {name}: only {same:.4f} of pixels agree")

    def slab(dev, **kw):
        s_ = cone_st[dev]
        return conesplat.render_cone_splat(
            s_.leaves, s_.pool.center, s_.pool.half_size, s_.pose,
            cfg.focal_x, cfg.focal_y, spec=spec, depth=cfg.max_depth, **kw)

    for name, kw in SLAB_MODES.items():
        a, b = slab("cuda", **kw).cpu(), slab("cpu", **kw)
        close = float(((a - b).abs().amax(-1) <= 1e-5).float().mean())
        print(f"[reference] slab {name}: pixels within 1e-5 {close:.4f}")
        check(bool(torch.isfinite(a).all()) and close >= 0.99,
              f"[reference] slab {name}: only {close:.4f} of pixels agree")
    sums = []
    for dev in ("cuda", "cpu"):
        lv = cone_st[dev].leaves
        live = (torch.arange(lv.keys.shape[0], device=dev) < lv.count) \
            & (lv.keys >= 0)
        sums.append(conesplat.slab_scatter_add(
            lv.vals, lv.keys, live, cone_st[dev].pool.center,
            cone_st[dev].pool.half_size, cone_st[dev].pose, cfg.focal_x,
            cfg.focal_y, spec=spec, depth=cfg.max_depth))
    check(int((sums[1][:, 0] > 0).sum()) > 0,
          "[reference] the accumulate sums are empty")
    _differing("accumulate sums", *sums, limit=0.0)

    # every optional branch of the step at once, rendered by the hybrid
    fcfg = dataclasses.replace(cfg, track_keyframe=True, saturation_gate=True,
                               insert_dircache=True, keyframe_max_dist=0.04)
    outs, states = {}, {}
    for dev in ("cuda", "cpu"):
        state = pipeline.init_state(fcfg, initial_pose=gts[0], device=dev)
        for f in frames:
            state, out = pipeline.step(
                state, type(f)(*(x.to(dev) for x in f)), fcfg,
                render="cone_hybrid")
        outs[dev], states[dev] = out, state
    g, c = outs["cuda"], outs["cpu"]
    dpose = float((g.pose.cpu() - c.pose).abs().max())
    same = _pixels_equal(g.framebuffer, c.framebuffer)
    print(f"[reference] keyframe + gate + cache, hybrid, card vs CPU: "
          f"max|d pose| {dpose:.2e}, leaves {int(g.map_leaves)} / "
          f"{int(c.map_leaves)}, framebuffer pixels equal {same:.4f}")
    check(dpose < 1e-4, "[reference] features: card and CPU poses differ")
    check(abs(int(g.map_leaves) - int(c.map_leaves))
          <= 0.01 * int(c.map_leaves), "[reference] features: leaves differ")
    check(same >= 0.99, f"[reference] features: only {same:.4f} of "
          f"framebuffer pixels agree")
    check(not bool(g.diverged) and not bool(c.diverged),
          "[reference] features: diverged")
    for name in ("dir_keys", "sat_mask"):
        _differing(f"features {name}", getattr(states["cuda"], name),
                   getattr(states["cpu"], name))
    # one leaf more or less on a device shifts every later registry
    # position, so the cached positions are held to their own registry
    for dev, st in states.items():
        live = st.dir_nodes >= 0
        check(int(live.sum()) > 0 and torch.equal(
            st.dir_pos[live], st.leaves.node2pos[st.dir_nodes[live].long()]),
            f"[reference] features: dir_pos on {dev} is not the registry's")
    check(not torch.equal(states["cpu"].key_pose, gts[0]),
          "[reference] features: the anchor never moved")

def _flat_fields(state):
    """{field name: numpy array} of a port state, packed words as uint32."""
    from octree_slam_tpu_torch import app, convert
    return app._flatten(convert.state_to_numpy(state))


def _orbit_ate(poses, gts_np) -> float:
    """The pinned orbit's ATE: the frames after the warm-up."""
    from octree_slam_tpu_torch.utils.metrics import ate_rmse
    return ate_rmse(np.stack(poses[ORBIT_WARMUP:]),
                    np.stack(gts_np[ORBIT_WARMUP:]))


def _run_slam(cfg, frames, gts, label, **kw):
    """app.run_slam over the orbit on the card, its JSON event lines kept
    (and echoed), the kernels' launch counts set to 0 just before and read
    just after, and its host reads counted. Returns (result, final state,
    events, launches, launch batches, host reads)."""
    from octree_slam_tpu_torch import app
    from octree_slam_tpu_torch.sensor import cuda_ops
    gts_np = [g.cpu().numpy() for g in gts]
    sink, out = [], io.StringIO()
    torch.cuda.synchronize()
    cuda_ops.reset_launches()
    with _HostReads() as reads, contextlib.redirect_stdout(out):
        res = app.run_slam(lambda i: frames[i], len(frames), cfg,
                           initial_pose=gts[0], gt_fn=lambda i: gts_np[i],
                           render_every=1, render_mode="splat",
                           state_out=sink, device="cuda", **kw)
        torch.cuda.synchronize()
    launches = dict(cuda_ops.LAUNCHES)
    batches = {k: dict(v) for k, v in cuda_ops.LAUNCH_BATCHES.items()}
    events = [json.loads(line) for line in out.getvalue().splitlines()
              if line.startswith("{")]
    for e in events:
        print(f"[{label}]   event {json.dumps(e)}")
    return res, sink[0], events, launches, batches, reads.count


def _bare_loop(cfg, frames, gts):
    """The orbit through init_state + step in a plain loop, timed as
    run_slam times its frames (host clock per frame, no synchronisation),
    with its host reads counted (init_state's uploads included). Returns
    (frame ms median, host reads)."""
    from octree_slam_tpu_torch import pipeline
    torch.cuda.synchronize()
    frame_s = []
    with _HostReads() as reads:
        state = pipeline.init_state(cfg, initial_pose=gts[0], device="cuda")
        t_prev = time.perf_counter()
        for f in frames:
            state, _ = pipeline.step(state, f, cfg)
            t = time.perf_counter()
            frame_s.append(t - t_prev)
            t_prev = t
        torch.cuda.synchronize()
    return 1e3 * statistics.median(frame_s), reads.count


def phase_app(smi: str, cfg, frames, gts):
    """Phase 11: the orbit through app.run_slam, held to the pinned map and
    ATE, in turns with the bare step loop (bare, app, app, bare): frame
    medians on the host clock and host reads of whole runs."""
    bare = [_bare_loop(cfg, frames, gts)]
    res, state, events, launches, _, reads = _run_slam(cfg, frames, gts,
                                                       "app")
    res2, _, _, _, _, reads2 = _run_slam(cfg, frames, gts, "app")
    bare.append(_bare_loop(cfg, frames, gts))
    gts_np = [g.cpu().numpy() for g in gts]
    ate = _orbit_ate(res.poses, gts_np)
    leaves = int(state.leaves.count)
    print(f"[app] {smi} | " + json.dumps({
        "frames": res.frames, "ate_rmse_m": ate, "map_nodes": res.map_nodes,
        "map_leaves": leaves, "diverged": res.diverged,
        "frame_ms_median_in_turns": {
            "bare": bare[0][0], "run_slam": 1e3 / res.steady_fps,
            "run_slam_again": 1e3 / res2.steady_fps, "bare_again": bare[1][0]},
        "host_reads_per_run": {"bare": bare[0][1], "run_slam": reads,
                               "run_slam_again": reads2,
                               "bare_again": bare[1][1]},
        "fps": res.fps, "max_frame_s": res.max_frame_s,
        "launches": launches}))
    check(res.frames == ORBIT_FRAMES and not res.diverged,
          "[app] the run did not finish tracked")
    check(abs(ate - ORBIT_ATE_M) <= ORBIT_ATE_TOL_M,
          f"[app] ATE {ate:.9f} m, expected {ORBIT_ATE_M}")
    check(res.map_nodes == ORBIT_MAP_NODES and leaves == ORBIT_MAP_LEAVES,
          f"[app] map {res.map_nodes} nodes / {leaves} leaves, expected "
          f"{ORBIT_MAP_NODES} / {ORBIT_MAP_LEAVES}")
    check(not events, f"[app] unexpected events {events}")
    for name in KERNELS:
        check(launches[name] == ORBIT_FRAMES,
              f"[app] {name} launches {launches[name]} != {ORBIT_FRAMES}")
    # the loop adds only the end of run's two reads (the live diverged
    # flag, the last map size) to the bare loop's: its trailing vector
    # waits on an event
    check(reads <= bare[0][1] + 2,
          f"[app] {reads} host reads against the bare loop's {bare[0][1]}")
    return state, res.final_cfg, launches


# the stamps of the reference package's checkpoint files beside `n` and the
# arrays a0 .. a{n-1}: its app.save_state's 15 and run2d.save_sharded's 13
REFERENCE_STAMPS = ("node_capacity", "leaf_capacity", "prealloc", "width",
                    "height", "pyramid_depth", "track_finest_level",
                    "fuse_level", "max_depth", "use_dense_mips",
                    "track_keyframe", "insert_dircache", "saturation_gate",
                    "insert_unique_cap", "voxel_resolution")
REFERENCE_SHARDED_STAMPS = ("node_capacity", "leaf_capacity", "prealloc",
                            "width", "height", "pyramid_depth",
                            "track_finest_level", "fuse_level", "max_depth",
                            "map_split_level", "insert_unique_cap",
                            "voxel_resolution", "n_shards")
# arrays cut off the tail of the legacy file (the most a reference file
# with the directory cache may lack: dir_nodes .. stamps_stale)
LEGACY_TAIL_CUT = 6


def _key_set_off(path: str, n_arrays: int, stamps) -> list:
    """The keys by which a checkpoint's key set differs from the reference
    package's: `n`, a0 .. a{n_arrays - 1} and `stamps`."""
    with np.load(path) as z:
        keys = set(z.files)
    want = {"n", *stamps, *(f"a{i}" for i in range(n_arrays))}
    return sorted(keys ^ want)


def _rewrite_file(src: str, dst: str, drop=(), cut: int = 0, **change):
    """A copy of a checkpoint without the keys `drop` and its last `cut`
    arrays, with `change` written over it: the reference package's legacy
    files. Returns the copy's arrays."""
    with np.load(src) as z:
        data = {k: z[k] for k in z.files if k not in drop}
    n = int(data["n"])
    for i in range(n - cut, n):
        del data[f"a{i}"]
    data["n"] = np.asarray(n - cut)
    data.update(change)
    np.savez(dst, **data)
    return data


def phase_checkpoint(smi: str, state, cfg, frames, gts):
    """Phase 12: save_state writes the reference package's file (its key
    set: n, a0 .. a{n-1}, the 15 stamps), load_state brings back every
    word on the card, and one more splat frame from the loaded state and
    from a copy of the original alike. Then two of the reference's legacy
    files, loaded on the card as its loader takes them: the file without
    its prealloc stamp (laid out under the legacy schedule: accepted where
    that equals this build's schedule, else refused), and a file of the
    orbit with the directory cache and the saturation gate whose last
    arrays are cut off (the directory reset, the mask rebuilt from the
    registry)."""
    from octree_slam_tpu_torch import app, convert, pipeline
    from octree_slam_tpu_torch.map import morton, svo
    names = convert.slam_state_leaf_names(cfg)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        t0 = time.perf_counter()
        app.save_state(path, state, cfg)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        keys_off = _key_set_off(path, len(names), REFERENCE_STAMPS)
        t0 = time.perf_counter()
        loaded, lcfg = app.load_state(path, cfg, device="cuda")
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        old = os.path.join(d, "prestamp.npz")
        _rewrite_file(path, old, drop=("prealloc",))
        try:
            prestamp, _ = app.load_state(old, cfg, device="cuda")
            refusal = None
        except ValueError as e:
            prestamp, refusal = None, str(e)
    a, b = _flat_fields(state), _flat_fields(loaded)
    off = {k: int(np.count_nonzero(a[k] != b[k])) for k in a
           if a[k].shape == b[k].shape}
    n_words = sum(v.size for v in a.values())
    s1, o1 = pipeline.step(loaded, frames[-1], lcfg)
    s2, o2 = pipeline.step(convert.clone_state(state), frames[-1], cfg)
    same = {"pose": torch.equal(o1.pose, o2.pose),
            "pool.value": torch.equal(s1.pool.value, s2.pool.value),
            "pool.child": torch.equal(s1.pool.child, s2.pool.child),
            "leaves.keys": torch.equal(s1.leaves.keys, s2.leaves.keys),
            "leaves.vals": torch.equal(s1.leaves.vals, s2.leaves.vals)}
    print(f"[checkpoint] {smi} | " + json.dumps({
        "save_s": t_save, "load_s": t_load, "file_bytes": size,
        "arrays": len(names), "keys_off_reference": keys_off,
        "fields": len(a), "words": int(n_words),
        "differing_words": sum(off.values()), "next_frame_equal": same}))
    check(not keys_off,
          f"[checkpoint] the file's keys differ from the reference's: "
          f"{keys_off}")
    check(a.keys() == b.keys() and len(off) == len(a),
          "[checkpoint] the loaded state has other fields or shapes")
    check(all(a[k].dtype == b[k].dtype for k in a),
          "[checkpoint] a loaded field has another dtype")
    check(not any(off.values()),
          f"[checkpoint] differing words: "
          f"{ {k: v for k, v in off.items() if v} }")
    check(lcfg == cfg, "[checkpoint] the loaded config differs")
    check(all(same.values()), f"[checkpoint] the next frame differs: {same}")
    del loaded, s1, s2

    # the pre-stamp file: the legacy schedule decides
    legacy = svo.prealloc_levels_legacy(cfg.node_capacity)
    current = svo.prealloc_levels(cfg.node_capacity)
    pre_off = None
    if prestamp is not None:
        c = _flat_fields(prestamp)
        pre_off = sum(int(np.count_nonzero(a[k] != c[k])) for k in a)
        del prestamp, c
    print(f"[checkpoint] prestamp {smi} | " + json.dumps({
        "node_capacity": cfg.node_capacity, "legacy_prealloc": legacy,
        "prealloc": current, "accepted": refusal is None,
        "differing_words": pre_off, "refusal": refusal}))
    check((refusal is None) == (legacy == current),
          f"[checkpoint] the pre-stamp file was "
          f"{'accepted' if refusal is None else 'refused'} with the legacy "
          f"schedule at {legacy} levels and this build's at {current}")
    check(refusal is None and pre_off == 0 or refusal is not None
          and "dense-preallocated" in refusal,
          f"[checkpoint] the pre-stamp file: {refusal or pre_off}")

    # the legacy tail, on the orbit with the directory cache and the gate
    tcfg = dataclasses.replace(cfg, insert_dircache=True,
                               saturation_gate=True)
    tstate = pipeline.init_state(tcfg, initial_pose=gts[0], device="cuda")
    for f in frames:
        tstate, _ = pipeline.step(tstate, f, tcfg)
    tnames = convert.slam_state_leaf_names(tcfg)
    own = _flat_fields(tstate)
    i_vals = tnames.index("leaves.vals")
    # 14 frames saturate no leaf (the highest alpha stays near 155): half
    # the live registry at alpha 255 gives the rebuilt mask bits to set
    count = int(tstate.leaves.count)
    vals = own["leaves.vals"].copy()
    vals[:count // 2] |= np.uint32(0xFF000000)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        app.save_state(path, tstate, tcfg)
        short = os.path.join(d, "tail.npz")
        written = _rewrite_file(path, short, cut=LEGACY_TAIL_CUT,
                                **{f"a{i_vals}": vals})
        t0 = time.perf_counter()
        tail, _ = app.load_state(short, tcfg, device="cuda")
        torch.cuda.synchronize()
        t_tail = time.perf_counter() - t0
    got = _flat_fields(tail)
    reset = ("dir_keys", "dir_nodes", "dir_vals", "dir_pos", "sat_mask")
    kept = [k for k in tnames[:-LEGACY_TAIL_CUT] if k not in reset]
    kept_off = sum(int(np.count_nonzero(got[k] != written[f"a{i}"]))
                   for i, k in enumerate(tnames) if k in kept)
    dir_reset = bool((got["dir_keys"] == morton.INVALID_KEY).all()
                     and (got["dir_nodes"] == -1).all()
                     and (got["dir_vals"] == 0).all()
                     and (got["dir_pos"] == -1).all())
    # the mask the registry implies: bit (key & 31) of word (key >> 5) of
    # every live key at alpha 255
    keys = own["leaves.keys"][:count]
    sat = keys[(vals[:count] >> 24) == 255]
    want_mask = np.zeros_like(own["sat_mask"])
    np.bitwise_or.at(want_mask, sat >> 5,
                     np.left_shift(np.uint32(1), (sat & 31).astype(np.uint32)))
    flags_cold = not bool(got["mirror_stale"]) and not bool(
        got["stamps_stale"])
    rep = {"arrays": len(tnames), "cut": LEGACY_TAIL_CUT, "load_s": t_tail,
           "kept_differing_words": kept_off,
           "dir_live_rows_saved": int(np.count_nonzero(
               own["dir_nodes"] >= 0)),
           "dir_reset": dir_reset,
           "own_sat_mask_nonzero_words": int(np.count_nonzero(
               own["sat_mask"])),
           "saturated_leaves": int(sat.size),
           "sat_mask_nonzero_words": int(np.count_nonzero(got["sat_mask"])),
           "sat_mask_equals_registry": bool(np.array_equal(got["sat_mask"],
                                                           want_mask)),
           "own_sat_mask_equals_rebuild": bool(np.array_equal(
               _flat_fields(pipeline.rebuild_sat_mask(tstate, tcfg))
               ["sat_mask"], own["sat_mask"])),
           "flags_cold": flags_cold}
    print(f"[checkpoint] legacy tail {smi} | " + json.dumps(rep))
    check(kept_off == 0, f"[checkpoint] legacy tail: {kept_off} words of "
          f"the kept arrays differ from the file's")
    check(rep["dir_live_rows_saved"] > 0 and dir_reset,
          f"[checkpoint] legacy tail: the directory was not reset: {rep}")
    check(rep["saturated_leaves"] > 0 and rep["sat_mask_equals_registry"]
          and rep["own_sat_mask_equals_rebuild"],
          f"[checkpoint] legacy tail: the saturation mask: {rep}")
    check(flags_cold, "[checkpoint] legacy tail: a staleness flag is set")
    del tstate, tail


def phase_tiering(smi: str, state, cfg):
    """Phase 13: every leaf spilled to host RAM (camera far away) and
    restored (camera back): the sorted (key, word) list and the refreshed
    interiors (through the dense mirror, keyed by cell) unchanged."""
    from octree_slam_tpu_torch import pipeline
    from octree_slam_tpu_torch.map import mips, svo, tiering
    lvl = pipeline._accel_level(cfg)

    def sorted_words(keys, vals):
        o = np.argsort(keys, kind="stable")
        return keys[o], vals[o]

    def mirror(pool):
        pool = svo.refresh_interior(pool._replace(value=pool.value.clone()),
                                    depth=cfg.max_depth)
        return mips.rebuild_from_pool(pool, max_depth=cfg.max_depth,
                                      dist_level=lvl).values

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, keys0, vals0 = tiering._leaf_snapshot(state, cfg)
    t_snap = time.perf_counter() - t0
    before = mirror(state.pool)
    tcfg = dataclasses.replace(cfg, host_spill=True)
    archive = tiering.HostArchive(tcfg.tier_level)
    cam = state.pose[:3, 3].cpu().numpy()
    t0 = time.perf_counter()
    state, tcfg, n_spilled = tiering.spill_cold(
        state, tcfg, archive, camera_pos=cam + 1000.0)
    torch.cuda.synchronize()
    t_spill = time.perf_counter() - t0
    n_left = int(state.leaves.count)
    ak = np.concatenate([k for k, _ in archive.cells.values()])
    av = np.concatenate([v for _, v in archive.cells.values()])
    n_cells = len(archive)
    arch_same = all(np.array_equal(x, y) for x, y in zip(
        sorted_words(ak, av), sorted_words(keys0, vals0)))
    big = dataclasses.replace(tcfg, restore_radius=1e6)
    t0 = time.perf_counter()
    state, big, n_restored = tiering.restore_due(state, big, archive,
                                                 camera_pos=cam)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    _, keys1, vals1 = tiering._leaf_snapshot(state, big)
    k0, v0 = sorted_words(keys0, vals0)
    k1, v1 = sorted_words(keys1, vals1)
    differing = (int(np.count_nonzero(v0 != v1)) if k0.shape == k1.shape
                 and np.array_equal(k0, k1) else -1)
    after = mirror(state.pool)
    interior_off = int((before != after).sum())
    print(f"[tiering] {smi} | " + json.dumps({
        "leaves": int(keys0.size), "snapshot_s": t_snap, "spill_s": t_spill,
        "spilled": n_spilled, "archived_cells": n_cells,
        "leaves_left_on_card": n_left, "archive_equals_snapshot": arch_same,
        "restore_s": t_restore, "restored": n_restored,
        "differing_leaf_words": differing,
        "differing_mirror_words_after_refresh": interior_off,
        "node_capacity": big.node_capacity}))
    check(n_spilled == keys0.size and n_left == 0 and arch_same,
          "[tiering] the archive does not hold every leaf of the snapshot")
    check(n_restored == keys0.size and len(archive) == 0,
          f"[tiering] restored {n_restored} of {keys0.size} leaves")
    check(differing == 0, f"[tiering] {differing} leaf words differ after "
          f"the round trip (-1: the key sets differ)")
    check(interior_off == 0, f"[tiering] {interior_off} refreshed words "
          f"differ after the round trip")


def _pre_nodes(keys: np.ndarray, depth: int, pre: int) -> int:
    """Nodes a pool with `pre` dense levels holds for these leaf keys: the
    dense region plus one 8-slot tile under every distinct level-l prefix
    of a leaf path, l = pre .. depth-1."""
    from octree_slam_tpu_torch.map import svo
    return svo._LEVEL_BASE[pre + 1] + 8 * sum(
        np.unique(keys >> (3 * (depth - l))).size for l in range(pre, depth))


def phase_grow(smi: str, cfg, frames, gts, registry, sizes):
    """Phase 14: the orbit through run_slam with capacities small enough
    that the 3/4 triggers fire: the pool's doubling crosses from 4 to 5
    dense levels (a rebuild), the registry's pads."""
    from octree_slam_tpu_torch.map import svo
    keys = registry[0].numpy()
    depth = cfg.max_depth
    n6 = _pre_nodes(keys, depth, svo.prealloc_levels(cfg.node_capacity))
    n4 = _pre_nodes(keys, depth, 4)
    lo = 8 * svo._LEVEL_BASE[6] // 2      # doubling from here on is 4 -> 5
    # the 3/4 trigger at 70% of the final 4-level node count at most
    node_cap = max(lo, -(-int(n4 * 0.7 / 0.75) // 8) * 8)
    leaf_cap = 1 << 16
    print(f"[grow] {smi} | orbit (nodes, leaves) by frame: {sizes} | final "
          f"leaves' node count with 6 dense levels {n6} (pool "
          f"{ORBIT_MAP_NODES}), with 4 dense levels {n4} | capacities "
          f"{node_cap} nodes, {leaf_cap} leaves")
    check(n6 == ORBIT_MAP_NODES, "[grow] the node count from the leaf keys "
          "does not reproduce the pool's")
    check(svo.prealloc_levels(node_cap) == 4
          and svo.prealloc_levels(2 * node_cap) == 5
          and node_cap * 3 // 4 < n4,
          f"[grow] no 4-level capacity has its 3/4 trigger below {n4} "
          f"nodes and crosses to 5 levels when doubled")
    gcfg = dataclasses.replace(cfg, node_capacity=node_cap,
                               leaf_capacity=leaf_cap)
    res, state, events, launches, _, _ = _run_slam(gcfg, frames, gts,
                                                   "grow")
    gts_np = [g.cpu().numpy() for g in gts]
    ate = _orbit_ate(res.poses, gts_np)
    fc = res.final_cfg
    grows = [e for e in events if e.get("event") == "map_grow"]
    pool = state.pool
    if bool(state.interior_stale):
        pool = svo.refresh_interior(
            pool._replace(value=pool.value.clone()), depth=depth)
    ex, _ = svo.extract_all_leaves(pool, depth=depth,
                                   start_capacity=fc.leaf_capacity)
    n = int(state.leaves.count)
    reg = torch.sort(state.leaves.keys[:n]).values
    ext = torch.sort(ex.keys[:int(ex.count)]).values
    same = reg.shape == ext.shape and torch.equal(reg, ext)
    print(f"[grow] {smi} | " + json.dumps({
        "ate_rmse_m": ate, "growth_frame_s": res.growth_frame_s,
        "max_frame_s": res.max_frame_s, "frame_ms_median": 1e3 / res.steady_fps,
        "node_capacity": [node_cap, fc.node_capacity],
        "leaf_capacity": [leaf_cap, fc.leaf_capacity],
        "dense_levels": [svo.prealloc_levels(node_cap),
                         svo.prealloc_levels(fc.node_capacity)],
        "map_nodes": res.map_nodes, "map_leaves": n,
        "pool_overflowed": bool(state.pool.overflowed),
        "registry_overflowed": bool(state.leaves.overflowed),
        "registry_equals_extraction": same, "launches": launches}))
    check(any(e["node_capacity"] == 2 * node_cap for e in grows),
          "[grow] the pool never doubled")
    check(any(e["leaf_capacity"] > leaf_cap for e in grows),
          "[grow] the registry never doubled")
    check(svo.prealloc_levels(fc.node_capacity) == 5,
          "[grow] the pool did not cross to 5 dense levels")
    check(not bool(state.pool.overflowed)
          and not bool(state.leaves.overflowed),
          "[grow] the pool or the registry overflowed")
    check(same, "[grow] the registry is not the extraction of the pool")
    check(not res.diverged and abs(ate - ORBIT_ATE_M) <= ORBIT_ATE_TOL_M,
          f"[grow] ATE {ate:.9f} m, expected {ORBIT_ATE_M}")
    for name in KERNELS:
        check(launches[name] == ORBIT_FRAMES,
              f"[grow] {name} launches {launches[name]} != {ORBIT_FRAMES}")
    return launches


def _test_helper(name: str):
    """A JAX-free helper module of tests/ (torch_fuzz, png_encoder); the
    directory goes at the end of sys.path, so it shadows no module."""
    import importlib
    import sys
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if d not in sys.path:
        sys.path.append(d)
    return importlib.import_module(name)


def phase_fuzz_map(smi: str):
    """Phase 20: the map's op interplay at a run's size: the rounds of
    FUZZ_ROUNDS (tests/torch_fuzz.py's draws, each op given, FUZZ_SPEC's
    sizes) on a pool on the card and on one on the CPU, held word for word
    after every round and, refreshed, with their leaves at the end."""
    tf = _test_helper("torch_fuzz")
    from octree_slam_tpu_torch.map import svo
    t_phase = time.perf_counter()
    spec = tf.Spec(**FUZZ_SPEC)
    ms = {"cuda": [], "cpu": []}

    def timed(dev):
        def apply(pool, op):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pool, passes = tf.apply_port(pool, op)
            torch.cuda.synchronize()
            ms[dev].append(1e3 * (time.perf_counter() - t0))
            return pool, passes
        return apply

    rounds, ops = [], []

    def record(step, rnd, targets, passes):
        card, cpu = targets
        recs = []
        for op, p, card_ms, cpu_ms in zip(rnd.ops, passes,
                                          ms["cuda"][len(ops):],
                                          ms["cpu"][len(ops):]):
            rec = {"op": op.kind, "card_ms": card_ms, "cpu_ms": cpu_ms,
                   "passes": p}
            if op.kind == "grow":
                rec["capacity"] = op.capacity
            elif op.kind == "insert":
                rec["points"] = int(op.points.shape[0])
            elif op.kind == "exact":
                rec["keys"] = int(op.keys.shape[0])
                rec["overwrite"] = op.overwrite
            recs.append(rec)
        ops.extend(recs)
        rounds.append({
            "round": step, "drawn": rnd.label, "ops": recs,
            "depth": rnd.depth, "capacity": card.capacity,
            "n_nodes": int(card.n_nodes),
            "half_size": float(card.half_size),
            "differing_words": tf.differing_words(tf.pool_arrays(card),
                                                  tf.pool_arrays(cpu))})
        print(f"[fuzz_map] {smi} | " + json.dumps(rounds[-1]))

    pools = [svo.create(spec.capacity, torch.zeros(3), spec.half_size,
                        device=dev) for dev in ("cuda", "cpu")]
    tf.run_rounds(np.random.default_rng(FUZZ_SEED), pools,
                  (timed("cuda"), timed("cpu")), spec, FUZZ_ROUNDS, record)
    depth = rounds[-1]["depth"]
    leaves = []
    for p in pools:
        ref, keys, nodes, words = tf.leaf_words(p, depth, 1 << 19)
        leaves.append({"value": ref.value.cpu().numpy(), "keys": keys,
                       "nodes": nodes, "words": words})
    refreshed_diff = tf.differing_words(*leaves)
    card = pools[0]
    summary = {
        "rounds": len(rounds), "ops": [o["op"] for o in ops],
        "grows": sum(o["op"] == "grow" for o in ops),
        "paged_inserts": sum(o["op"] == "insert" and o["passes"][0] > 1
                             for o in ops),
        "depth": depth, "capacity": card.capacity,
        "n_nodes": int(card.n_nodes), "leaves": int(leaves[1]["keys"].size),
        "differing_words": sum(r["differing_words"] for r in rounds),
        "refreshed_differing_words": refreshed_diff,
        "card_ms_by_op": {k: sum(o["card_ms"] for o in ops if o["op"] == k)
                          for k in ("insert", "exact", "grow", "reroot")},
        "phase_s": time.perf_counter() - t_phase}
    print(f"[fuzz_map] {smi} | " + json.dumps(summary))
    for r in rounds:
        check(r["differing_words"] == 0,
              f"[fuzz_map] round {r['round']} ({r['drawn']}): "
              f"{r['differing_words']} words differ, card against CPU")
    check(refreshed_diff == 0, f"[fuzz_map] the refreshed pools or their "
          f"leaves differ in {refreshed_diff} words")
    check(all(o["passes"][0] == o["passes"][1] for o in ops),
          "[fuzz_map] the card and the CPU paged differently")
    check(summary["grows"] >= 2 and summary["paged_inserts"] > 0
          and depth == FUZZ_SPEC["max_depth"] and summary["leaves"] > 0,
          f"[fuzz_map] the rounds did not grow twice, page and re-root: "
          f"{summary}")


def phase_relocalize(smi: str, cfg, frames, gts):
    """Phase 15: the orbit with frame RELOC_GARBAGE_FRAME blanked (zero
    depth and colour) recovers by relocalization; each attempt is one
    launch of each kernel over the four candidates."""
    rcfg = dataclasses.replace(cfg, keypose_every=2,
                               reloc_candidates=RELOC_CANDIDATES)
    f = frames[RELOC_GARBAGE_FRAME]
    frames = list(frames)
    frames[RELOC_GARBAGE_FRAME] = type(f)(torch.zeros_like(f.depth),
                                          torch.zeros_like(f.color),
                                          f.timestamp)
    t0 = time.perf_counter()
    res, state, events, launches, batches, _ = _run_slam(
        rcfg, frames, gts, "relocalize")
    wall = time.perf_counter() - t0
    attempts = [e for e in events
                if e.get("event") in ("relocalize", "relocalize_failed")]
    gt_last = gts[-1].cpu().numpy()
    err = float(np.linalg.norm(res.poses[-1][:3, 3] - gt_last[:3, 3]))

    # one attempt alone on the recovered state, timed, with its launches
    from octree_slam_tpu_torch import relocalize
    from octree_slam_tpu_torch.sensor import cuda_ops
    keyposes = [p for p in res.poses[:RELOC_GARBAGE_FRAME:2]]
    for _ in range(2):
        torch.cuda.synchronize()
        cuda_ops.reset_launches()
        with _HostReads() as reads:
            t0 = time.perf_counter()
            _, ok, diag = relocalize.relocalize(state, rcfg, keyposes)
            attempt_ms = 1e3 * (time.perf_counter() - t0)
    one = dict(cuda_ops.LAUNCHES)
    print(f"[relocalize] {smi} | " + json.dumps({
        "relocalizations": res.relocalizations,
        "attempts": len(attempts), "diverged": res.diverged,
        "last_frame_translation_err_m": err, "run_wall_s": wall,
        "launches": launches, "launch_batches": batches,
        "attempt_ms": attempt_ms, "attempt_launches": one,
        "attempt_host_reads": reads.count, "attempt_ok": ok,
        "attempt_diag": diag,
        "min_inliers": int(rcfg.reloc_min_inlier_frac * rcfg.num_pixels)}))
    check(res.relocalizations >= 1, "[relocalize] no recovery")
    check(not res.diverged, "[relocalize] diverged at the end")
    check(err < RELOC_ERR_MAX_M,
          f"[relocalize] last frame {err:.4f} m off, bound {RELOC_ERR_MAX_M}")
    check(len(attempts) >= 1, "[relocalize] no attempt")
    for name in KERNELS:
        want = {1: ORBIT_FRAMES, RELOC_CANDIDATES: len(attempts)}
        check(launches[name] == ORBIT_FRAMES + len(attempts)
              and batches[name] == want,
              f"[relocalize] {name}: {launches[name]} launches by batch "
              f"{batches[name]}, expected {want}")
        check(one[name] == 1, f"[relocalize] one attempt launched {name} "
              f"{one[name]} times")
    return launches


def phase_tum(smi: str):
    """Phase 16: a 14-frame 640x480 TUM-format sequence written by the
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
        root = tum.write_sequence(os.path.join(d, "seq"), ORBIT_FRAMES,
                                  640, 480, device="cuda")
        t_write = time.perf_counter() - t0
        traj = os.path.join(d, "traj.txt")
        out = io.StringIO()
        torch.cuda.synchronize()
        cuda_ops.reset_launches()
        with contextlib.redirect_stdout(out):
            app.main(["--source", "tum", "--tum-root", root, "--frames",
                      str(ORBIT_FRAMES), "--save-trajectory", traj,
                      "--log-every", "0"])
            torch.cuda.synchronize()
        launches = dict(cuda_ops.LAUNCHES)
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        est = tum._read_groundtruth(traj)

        ds = tum.TUMDataset(root, max_frames=ORBIT_FRAMES, device="cuda")
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
    check(rec["frames"] == ORBIT_FRAMES and rec["diverged"] is False,
          f"[tum] the CLI run: {rec}")
    check(rec["ate_rmse"] is not None and rec["ate_rmse"] < FEATURE_ATE_MAX_M,
          f"[tum] the CLI run's ATE {rec['ate_rmse']}")
    check(len(est) == ORBIT_FRAMES
          and all(np.isfinite(T).all() for _, T in est),
          "[tum] the trajectory file does not read back")
    check(not res.diverged and not e2e.diverged
          and res.ate_rmse < FEATURE_ATE_MAX_M
          and e2e.ate_rmse < FEATURE_ATE_MAX_M,
          "[tum] the timed runs lost track")
    for name in KERNELS:
        check(launches[name] == ORBIT_FRAMES,
              f"[tum] {name} launches {launches[name]} != {ORBIT_FRAMES}")
    return launches


def _uv_surface(pos_fn, nrm_fn, nu: int, nv: int, u_max: float,
                v_max: float):
    """A parametric surface as a (nu+1) x (nv+1) vertex grid (the seam
    repeated, so each vertex has one uv) and 2 * nu * nv triangles."""
    u = np.linspace(0.0, u_max, nu + 1)
    v = np.linspace(0.0, v_max, nv + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    verts = pos_fn(uu, vv).reshape(-1, 3)
    nrms = nrm_fn(uu, vv).reshape(-1, 3)
    uv = np.stack([uu / u_max, vv / v_max], -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = (i * (nv + 1) + j).reshape(-1)
    b, c, e = a + nv + 1, a + nv + 2, a + 1
    faces = np.concatenate([np.stack([a, b, c], -1), np.stack([a, c, e], -1)])
    return verts, nrms, uv, faces


def offline_mesh(n_sphere, n_torus):
    """A UV sphere beside a torus, built in code: f32 vertices, normals,
    per-corner uv and i32 faces; 2 * nu * nv triangles each."""
    def sphere(t, p):
        return np.stack([np.sin(p) * np.cos(t), np.cos(p),
                         np.sin(p) * np.sin(t)], -1)

    def torus(t, p):
        ring = 0.34 + 0.14 * np.cos(p)
        return np.stack([ring * np.cos(t), 0.14 * np.sin(p),
                         ring * np.sin(t)], -1)

    def torus_n(t, p):
        return np.stack([np.cos(p) * np.cos(t), np.sin(p),
                         np.cos(p) * np.sin(t)], -1)

    sv, sn, suv, sf = _uv_surface(lambda t, p: 0.42 * sphere(t, p)
                                  + [-0.48, 0.0, 0.0], sphere,
                                  *n_sphere, 2 * np.pi, np.pi)
    tv, tn, tuv, tf = _uv_surface(lambda t, p: torus(t, p) + [0.52, 0.05,
                                                              0.1],
                                  torus_n, *n_torus, 2 * np.pi, 2 * np.pi)
    verts = np.concatenate([sv, tv]).astype(np.float32)
    faces = np.concatenate([sf, tf + len(sv)]).astype(np.int32)
    uv = np.concatenate([suv, tuv]).astype(np.float32)
    return (verts, np.concatenate([sn, tn]).astype(np.float32), faces,
            uv[faces])


def _checker(size=256, block=32):
    y, x = np.mgrid[:size, :size]
    on = ((x // block + y // block) % 2).astype(bool)
    rgb = np.stack([np.where(on, 230, 40 + x // 2), np.where(on, 60, 200),
                    np.where(on, 30 + y // 2, 90)], -1)
    return rgb.astype(np.uint8)


def _write_textured_obj(path, v, n, f, uv):
    """A textured OBJ: 'v' and 'vn' lines a vertex, a 'vt' line a face
    corner, faces as v/vt/vn (the port's save_obj, like the reference's,
    writes no texcoords)."""
    f1 = f.astype(np.int64) + 1
    t1 = np.arange(1, 3 * len(f) + 1).reshape(-1, 3)
    with open(path, "w") as out:
        for fmt, rows in (("v %.6f %.6f %.6f", v), ("vt %.6f %.6f",
                                                    uv.reshape(-1, 2)),
                          ("vn %.6f %.6f %.6f", n),
                          ("f %d/%d/%d %d/%d/%d %d/%d/%d",
                           np.stack([f1, t1, f1], -1).reshape(-1, 9))):
            out.write("\n".join(fmt % tuple(r) for r in rows.tolist()))
            out.write("\n")


def _palette_checker(size=256, block=32):
    """A 16-colour palette texture: (indices u8[size, size], palette
    u8[16, 3]); the checker's cells cycle through the palette."""
    y, x = np.mgrid[:size, :size]
    idx = ((x // block + 3 * (y // block)) % 16).astype(np.uint8)
    pal = np.random.default_rng(6).integers(0, 256, (16, 3)).astype(np.uint8)
    return idx, pal


def _write_assets(d, name, n_sphere, n_torus):
    """The mesh as a textured OBJ and the checker through the port's BMP
    writer; returns (obj path, bmp path, faces)."""
    from octree_slam_tpu_torch.io import bmp
    v, n, f, uv = offline_mesh(n_sphere, n_torus)
    paths = (os.path.join(d, f"{name}.obj"), os.path.join(d, f"{name}.bmp"))
    _write_textured_obj(paths[0], v, n, f, uv)
    bmp.save_bmp(paths[1], _checker())
    return paths[0], paths[1], len(f)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _profile_call(tag, smi, fn, wall_ms):
    """torch.profiler over one call of fn (after one warm call): device
    busy time, kernel count, the device's idle share against `wall_ms`
    (the call's time without the profiler), the host's launch calls and
    the largest kernels."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if getattr(e, "device_type", None) == cuda]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    launch = sum(e.cpu_time_total for e in events
                 if e.key == "cudaLaunchKernel") / 1e3
    # float64 work of utils/fma.py: the kernels instantiated for double
    # (its products and sums, and the casts into float64; the casts back
    # to float32 are instantiated for float and are not in this sum)
    f64 = [e for e in kernels if "double" in e.key]
    f64_ms = sum(e.self_device_time_total for e in f64) / 1e3
    print(f"{tag} {smi} | device busy {busy:.3f} ms, "
          f"{sum(e.count for e in kernels)} kernels | call without the "
          f"profiler {wall_ms:.3f} ms, so the device is idle "
          f"{100 * (1 - busy / wall_ms):.1f}% of it | cudaLaunchKernel "
          f"{launch:.3f} ms host | float64 kernels {f64_ms:.3f} ms "
          f"x{sum(e.count for e in f64)}, {100 * f64_ms / busy:.1f}% of "
          f"the busy time")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:6]:
        print(f"{tag}   kernel {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:<5d} {e.key[:80]}")


def _count_obj(path):
    nv = nf = 0
    with open(path) as f:
        for line in f:
            nv += line.startswith("v ")
            nf += line.startswith("f ")
    return nv, nf


def phase_offline(smi: str, profile=None):
    """Phase 18: the offline paths at the reference's full size. An in-code
    sphere and torus of 100,000 triangles with a 256x256 checker, written
    with the port's OBJ and BMP writers and read back through Scene; the
    256^3 grid (budget 512) twice, word for word the same, its occupied
    set equal to the A-buffer's, THIN inside CONSERVATIVE; a reduced mesh
    (2,048 triangles, 64^3) card against CPU, grid, A-buffer and a 160x120
    rasterization of its voxel cubes, word for word; the grid into the
    octree, a 640x480 cone trace of it and a 640x480 textured
    rasterization of the mesh; the voxel view as splats and as cubes; and
    the CLI's --save-mesh after the 14-frame orbit, 8 vertices and 12
    faces a leaf. A 16-colour palette PNG, read by the port's codec,
    voxelizes the mesh word for word as the same texture stored as RGB8."""
    from octree_slam_tpu_torch import SLAMConfig, app
    from octree_slam_tpu_torch.core import camera
    from octree_slam_tpu_torch.map import morton
    from octree_slam_tpu_torch.map import voxelization as vox
    from octree_slam_tpu_torch.render import raster
    from octree_slam_tpu_torch.render.renderer import Renderer
    from octree_slam_tpu_torch.scene import Scene
    from octree_slam_tpu_torch.sensor import cuda_ops
    torch.cuda.synchronize()
    cuda_ops.reset_launches()
    rec = {}
    with tempfile.TemporaryDirectory() as d:
        full_obj, full_bmp, n_tri = _write_assets(d, "full", (250, 100),
                                                  (250, 100))
        small_obj, small_bmp, n_small = _write_assets(d, "small", (32, 16),
                                                      (32, 16))
        check(n_tri == 100_000 and n_small == 2_048,
              f"[offline] meshes of {n_tri} / {n_small} triangles")
        cfg = SLAMConfig(vox_log_n=8, vox_tri_budget=512,
                         extract_capacity=1 << 20, node_capacity=1 << 21)
        scene = Scene(cfg, device="cuda")
        mesh = scene.load_obj_file(full_obj)
        tex = scene.load_texture(full_bmp)
        check(mesh.faces.shape[0] == n_tri, "[offline] the OBJ read back "
              f"with {mesh.faces.shape[0]} faces")
        lo, hi = mesh.bbox
        kw = dict(log_n=8, tri_budget=512)
        torch.cuda.reset_peak_memory_stats()
        soup, rec["prepare_ms"] = _timed(
            lambda: vox.prepare_mesh(mesh, mesh.bbox, 8, 512))
        grids, times = [], []
        for _ in range(2):
            g, ms = _timed(lambda: vox.voxelize(soup, tex.data, lo, hi, **kw))
            grids.append(g)
            times.append(ms)
        rec["voxelize_ms"] = times
        rec["voxelize_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        check(torch.equal(grids[0], grids[1]),
              "[offline] two voxelizations of the 256^3 grid differ")
        if profile == "offline":
            _profile_call("[profile offline voxelize]", smi,
                          lambda: vox.voxelize(soup, tex.data, lo, hi, **kw),
                          times[-1])
        grid = grids.pop()
        occ = grid.reshape(-1) != 0
        rec["occupied_voxels"] = int(occ.sum())
        cons, rec["voxelize_conservative_ms"] = _timed(
            lambda: vox.voxelize(soup, tex.data, lo, hi, conservative=True,
                                 **kw))
        rec["occupied_conservative"] = int((cons != 0).sum())
        check(not bool((occ & (cons.reshape(-1) == 0)).any()),
              "[offline] a THIN voxel is not in the CONSERVATIVE grid")
        del cons
        ab, rec["abuffer_ms"] = _timed(lambda: vox.voxelize_abuffer(
            soup, lo, hi, capacity=1 << 23, **kw))
        rec["abuffer_fragments"] = int(ab.count)
        if profile == "offline":
            _profile_call("[profile offline abuffer]", smi,
                          lambda: vox.voxelize_abuffer(
                              soup, lo, hi, capacity=1 << 23, **kw),
                          rec["abuffer_ms"])
        check(not bool(ab.overflowed), "[offline] the A-buffer overflowed")
        # a palette PNG through the port's codec (no PIL needed), against
        # the same texture as RGB8; both files written by the tests'
        # encoder (random row filters), not by the codec under check
        import importlib.util
        enc = _test_helper("png_encoder")
        idx, pal = _palette_checker()
        pal_png = os.path.join(d, "palette.png")
        rgb_png = os.path.join(d, "palette_rgb8.png")
        enc.write_png(pal_png, idx, 8, 3, palette=pal, seed=1)
        enc.write_png(rgb_png, pal[idx], 8, 2, seed=2)
        ptex = Scene(cfg, device="cuda").load_texture(pal_png)
        rtex = Scene(cfg, device="cuda").load_texture(rgb_png)
        pgrid = vox.voxelize(soup, ptex.data, lo, hi, **kw)
        rgrid = vox.voxelize(soup, rtex.data, lo, hi, **kw)
        rec["palette_texture"] = {
            "pil_installed": importlib.util.find_spec("PIL") is not None,
            "texels_differing": int((ptex.data != rtex.data).sum()),
            "grid_words_differing": int((pgrid != rgrid).sum()),
            "occupied_voxels": int((pgrid != 0).sum())}
        check(rec["palette_texture"]["texels_differing"] == 0
              and rec["palette_texture"]["grid_words_differing"] == 0
              and rec["palette_texture"]["occupied_voxels"] > 0,
              f"[offline] the palette texture: {rec['palette_texture']}")
        del pgrid, rgrid, ptex, rtex
        ab_set = torch.unique_consecutive(ab.frag_voxel[:int(ab.count)])
        check(torch.equal(ab_set, torch.nonzero(occ).squeeze(1)
                          .to(torch.int32)),
              "[offline] the A-buffer's occupied set is not the grid's")
        del ab, ab_set, grid, grids, soup
        lists = []
        for _ in range(2):
            g, ms = _timed(lambda: scene.voxelize_meshes(octree=False))
            lists.append(g)
            rec.setdefault("voxelize_meshes_ms", []).append(ms)
        check(all(torch.equal(a, b) for a, b in zip(lists[0][:3],
                                                    lists[1][:3]))
              and int(lists[0].count) == rec["occupied_voxels"],
              "[offline] voxelize_meshes is not deterministic or lost cells")
        del lists

        # the reduced mesh: card against CPU, word for word
        words = []
        for dev in ("cpu", "cuda"):
            s = Scene(dataclasses.replace(cfg, vox_log_n=6), device=dev)
            m = s.load_obj_file(small_obj)
            t = s.load_texture(small_bmp)
            sp = vox.prepare_mesh(m, m.bbox, 6, 512)
            g = vox.voxelize(sp, t.data, *m.bbox, log_n=6, tri_budget=512)
            a = vox.voxelize_abuffer(sp, *m.bbox, log_n=6, tri_budget=512,
                                     capacity=1 << 17)
            cubes = vox.voxel_grid_to_mesh(s.voxelize_meshes())
            mvp = camera.make_camera((0.2, 1.1, 2.6), (0.0, 0.0, 0.0),
                                     (0.0, 1.0, 0.0), 50.0, 4 / 3,
                                     device="cpu").mvp
            fb = raster.rasterize(raster.assemble(cubes), mvp.to(dev),
                                  width=160, height=120, frag_budget=64,
                                  shading="color", cull_backfaces=False)
            words.append([g, *a, fb])
        cpu, card = ([x.cpu() for x in w] for w in words)
        names = ["grid", "frag_voxel", "frag_tri", "count", "overflowed",
                 "raster"]
        rec["reduced_card_vs_cpu_differing"] = {
            n: int((a != b).sum()) for n, a, b in zip(names, cpu, card)}
        rec["reduced_occupied"] = int((cpu[0] != 0).sum())
        rec["reduced_raster_covered"] = int(cpu[-1][..., 3].sum())
        check(all(v == 0 for v in
                  rec["reduced_card_vs_cpu_differing"].values()),
              "[offline] card and CPU differ on the reduced mesh: "
              f"{rec['reduced_card_vs_cpu_differing']}")
        check(rec["reduced_raster_covered"] > 1000,
              "[offline] the cube raster covers too little")

        # into the octree, then the views at 640x480
        vg, rec["voxelize_and_insert_ms"] = _timed(
            lambda: scene.voxelize_meshes(octree=True))
        rec["octree_voxels"] = int(vg.count)
        rec["octree_depth"] = scene.tree.max_depth
        # each occupied grid cell lands in the leaf holding its centre
        # (several cells may share one: the grid's cells are not cubes)
        g = scene.voxelize_meshes()
        keys, _ = morton.encode(g.centers[:int(g.count)],
                                scene.tree.pool.center,
                                scene.tree.pool.half_size,
                                scene.tree.max_depth)
        rec["octree_leaves_expected"] = int(torch.unique(keys).numel())
        check(rec["octree_voxels"] == rec["octree_leaves_expected"],
              f"[offline] the octree holds {rec['octree_voxels']} voxels, "
              f"expected {rec['octree_leaves_expected']}")
        scene.voxel_grid = vg
        r = Renderer(640, 480)
        pose = torch.eye(4, device="cuda")
        pose[:3, 3] = torch.tensor([0.0, 0.0, -2.4])
        for _ in range(2):
            fb, ms = _timed(lambda: r.cone_trace_svo(
                scene.svo(), pose, 525.0, 525.0, scene.tree.max_depth))
            rec.setdefault("cone_trace_ms", []).append(ms)
        rec["cone_trace_coverage"] = float(
            (fb[..., :3].amax(-1) > 0).float().mean())
        cam = camera.make_camera((0.3, 0.9, 2.2), (0.0, 0.0, 0.0),
                                 (0.0, 1.0, 0.0), 55.0, 4 / 3, device="cpu")
        cam = type(cam)(*(x.cuda() for x in cam))
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            fb, ms = _timed(lambda: r.rasterize(mesh, cam, tex))
            rec.setdefault("raster_ms", []).append(ms)
        rec["raster_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        if profile == "offline":
            _profile_call("[profile offline raster]", smi,
                          lambda: r.rasterize(mesh, cam, tex),
                          rec["raster_ms"][-1])
        rec["raster_coverage"] = float(fb[..., 3].mean())
        for cubes in (False, True):
            fb, ms = _timed(lambda: r.rasterize_voxels(vg, cam,
                                                       use_cubes=cubes))
            key = "voxels_cubes" if cubes else "voxels_splats"
            rec[key + "_ms"] = ms
            rec[key + "_coverage"] = float(fb[..., 3].mean())
        check(min(rec["cone_trace_coverage"], rec["raster_coverage"],
                  rec["voxels_splats_coverage"],
                  rec["voxels_cubes_coverage"]) > 0.01,
              f"[offline] a view is empty: {rec}")
        del scene, vg, fb, mesh, tex

        # the CLI's --save-mesh after the orbit
        path = os.path.join(d, "map.obj")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            (res, rec["cli_s"]) = _timed(lambda: app.main([
                "--frames", str(ORBIT_FRAMES), "--render-every", "0",
                "--log-every", "0", "--node-capacity", str(1 << 20),
                "--save-mesh", path]))
        rec["cli_s"] /= 1e3
        rec["cli"] = json.loads(out.getvalue().strip().splitlines()[-1])
        nv, nf = _count_obj(path)
        rec["obj_vertices"], rec["obj_faces"] = nv, nf
        rec["obj_mib"] = os.path.getsize(path) / 2**20
    launches = dict(cuda_ops.LAUNCHES)
    rec["launches"] = launches
    print(f"[offline] {smi} | " + json.dumps(rec))
    check(not res.diverged and rec["cli"]["ate_rmse"] < FEATURE_ATE_MAX_M,
          f"[offline] the CLI orbit: {rec['cli']}")
    check(nv == 8 * ORBIT_MAP_LEAVES and nf == 12 * ORBIT_MAP_LEAVES,
          f"[offline] the OBJ has {nv} vertices and {nf} faces, expected 8 "
          f"and 12 times {ORBIT_MAP_LEAVES} leaves")
    for name in KERNELS:
        check(launches[name] == ORBIT_FRAMES,
              f"[offline] {name} launches {launches[name]} != "
              f"{ORBIT_FRAMES}")
    return launches


# ------------------------------------------------------------------ [knobs]

# the hybrid's band knobs on phase 10's map, each beside bench.py's band
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
    """Phase 19: what the reference runs beyond the defaults, at full width.
    The bilateral of other window sizes (_window_phase); then on phase 10's
    map the hybrid's band knobs, each through step("cone_hybrid"), and the
    slab cone's modes, each with its PSNR against the exact march, its
    render time (CUDA events) and its device operations a render. The
    compacting march must give the fixed-trip image bit for bit, the base
    hybrid and the default slab mode must keep phase 10's PSNRs, and the
    crawl must keep the reference's contract on the reference's scene
    (_crawl_contract); its gap at full width is printed. Returns
    (bilateral_window's report, the 5x5 orbit's launches)."""
    from octree_slam_tpu_torch import convert, pipeline
    from octree_slam_tpu_torch.render import conesplat, hybrid
    t_phase = time.perf_counter()
    report, launches = _window_phase(smi, cfg, frames, gts)

    # phase 10's map: 13 splat frames, the last frame by each render
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
    print(f"[knobs] {smi} | hybrid band knobs, {HYBRID_BAND} unless "
          f"named: " + json.dumps(band))
    print(f"[knobs] compact_after=8 x 96 packs its live lanes into "
          f"{max(128, HYBRID_BAND['cone_band_cap'] // 4)} after trip "
          f"{packed_at}; {long_off} framebuffer words differ from the "
          f"fixed-trip crawl=1 x 96")
    check(packed_at > 0, "[knobs] the 96-trip band march never packed")
    check(long_off == 0, "[knobs] the packed band march's image is not the "
          "fixed-trip one")
    check(abs(band[BAND_BASE]["psnr_db"] - fidelity["cone_hybrid_psnr_db"])
          < 0.01, "[knobs] the base hybrid's PSNR moved from phase 10's")
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
          "[knobs] the default slab mode's PSNR moved from phase 10's")
    print(f"[knobs] phase wall {time.perf_counter() - t_phase:.1f} s")
    return report, launches


# the [multichip] phase: the map shards of each mesh, and the 2-D mesh's
# pose tolerance against the single-device orbit (the slab sums of the
# normal equations add in another order)
MULTICHIP_MESHES = ((1, 8), (2, 4))
MULTICHIP_POSE_TOL = 1e-5
MULTICHIP_ATE_TOL_M = 1e-5


def _timed_frames(frames, events):
    """The frames as an iterator that records a CUDA event as each is
    taken: consecutive events bracket one iteration of the consumer's loop
    (its step and its trailing signal read)."""
    for f in frames:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        yield f


def _run_2d(cfg, mesh, frames, gts, render, **kw):
    """run2d.run_slam_2d over the orbit on the card with the kernels'
    counts set to 0 just before and read just after, frame times by CUDA
    events (the frames after the warm-up) and the peak memory. Returns
    (state, cfg, info, report)."""
    from octree_slam_tpu_torch.parallel import run2d
    from octree_slam_tpu_torch.sensor import cuda_ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = []
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    state, cfg2, info = run2d.run_slam_2d(
        _timed_frames(frames, events), cfg, mesh, initial_pose=gts[0],
        render=render, **kw)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)
    events.append(end)
    ms = [a.elapsed_time(b) for a, b in zip(events[:-1], events[1:])]
    return state, cfg2, info, {
        "render": render, "mesh": mesh.shape, "launches": launches,
        "frame_ms_median": statistics.median(ms[ORBIT_WARMUP:]),
        "wall_s": wall,
        "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20,
        "events": [e["event"] for e in info["events"]]}


def _union_leaf_list(smap):
    """The union of the shards' registries as one single-device LeafList
    (keys, words; node indices are the shards' own and unused by the
    renderers)."""
    from octree_slam_tpu_torch.render.splat import LeafList
    keys = torch.cat([lv.keys for lv in smap.leaves])
    return LeafList(keys=keys, nodes=torch.cat([lv.nodes
                                                for lv in smap.leaves]),
                    vals=torch.cat([lv.vals for lv in smap.leaves]),
                    node2pos=keys.new_zeros((1,)),
                    count=torch.tensor(keys.shape[0], dtype=torch.int32,
                                       device=keys.device),
                    overflowed=torch.zeros((), dtype=torch.bool,
                                           device=keys.device))


def _union_pool(smap, cfg):
    """One pool holding exactly the union's leaf words, interiors
    refreshed (the single-device map of the same leaves)."""
    from octree_slam_tpu_torch import pipeline
    from octree_slam_tpu_torch.map import svo, tiering
    from octree_slam_tpu_torch.parallel import run2d
    keys, vals = run2d.union_leaves(smap)
    p0 = smap.pools[0]
    pool = svo.create(cfg.node_capacity * len(smap.pools), p0.center,
                      p0.half_size, device="cuda")
    pool, _ = tiering.bulk_insert_exact(
        pool, keys, vals, depth=cfg.max_depth,
        unique_cap=cfg.insert_unique_cap,
        shallow_level=pipeline._accel_level(cfg), overwrite=True)
    return svo.refresh_interior(pool, depth=cfg.max_depth)


def _render_checks(smap, pose, cfg, mesh, render, fb):
    """The 2-D mesh's render of its map against the single-device
    renderer on the same leaves: the splat's packed z-buffer words and its
    finished image bit for bit; the cone's slab words bit for bit (min
    per shard then across shards is the global scatter-min) and its image
    to 1 ulp; the hybrid's union mirror word for word against one rebuilt
    from a pool of the same leaves, and its image within 1e-5 on all but
    0.5% of pixels at > 40 dB (the bounds of tests/test_run2d.py)."""
    from octree_slam_tpu_torch import pipeline
    from octree_slam_tpu_torch.map import mips
    from octree_slam_tpu_torch.parallel import distributed
    from octree_slam_tpu_torch.render import conesplat, hybrid, splat
    spec = pipeline._slab_spec(cfg)
    leaves = _union_leaf_list(smap)
    p0 = smap.pools[0]
    fx, fy = cfg.focal_x, cfg.focal_y
    out = {}
    if render == "splat":
        words = distributed.model_zbuffer_sharded(smap, pose, cfg, mesh)
        one = splat.splat_zbuffer(
            leaves.vals, leaves.keys, leaves.keys >= 0, p0.center,
            p0.half_size, pose, fx, fy, width=cfg.width, height=cfg.height,
            depth=cfg.max_depth, max_range=cfg.max_range)
        ref = splat.finish_zbuffer(one, width=cfg.width, height=cfg.height)
        out = {"differing_zbuffer_words": int((words != one).sum()),
               "zbuffer_words": int(words.numel()),
               "differing_image_values": int((fb != ref).sum())}
        check(out["differing_zbuffer_words"] == 0,
              f"[multichip] splat: {out['differing_zbuffer_words']} z-buffer "
              f"words differ from the single-device splat")
        check(out["differing_image_values"] == 0,
              f"[multichip] splat: {out['differing_image_values']} image "
              f"values differ from the single-device splat")
    elif render == "cone":
        words = distributed.slab_words_sharded(smap, pose, fx, fy, cfg, spec)
        one = conesplat.slab_scatter_min(
            leaves.vals, leaves.keys, leaves.keys >= 0, p0.center,
            p0.half_size, pose, fx, fy, spec=spec, depth=cfg.max_depth)
        ref = conesplat.render_cone_splat(leaves, p0.center, p0.half_size,
                                          pose, fx, fy, spec=spec,
                                          depth=cfg.max_depth)
        out = {"differing_slab_words": int((words != one).sum()),
               "slab_words": int(words.numel()),
               "image_max_abs_diff": float((fb - ref).abs().max())}
        check(out["differing_slab_words"] == 0,
              f"[multichip] cone: {out['differing_slab_words']} slab words "
              f"differ from the global scatter-min")
        check(out["image_max_abs_diff"] <= 2e-7,
              f"[multichip] cone image off by {out['image_max_abs_diff']}")
    elif render == "cone_hybrid":
        lvl = pipeline._accel_level(cfg)
        cache, _ = distributed.union_leaf_mirror(smap, cfg)
        one = mips.rebuild_from_pool(_union_pool(smap, cfg),
                                     max_depth=cfg.max_depth, dist_level=lvl,
                                     max_skip=cfg.dist_max_skip)
        one = mips.encode_free_dist(one, max_depth=cfg.max_depth,
                                    dist_level=lvl)
        lo = mips.level_offset(cfg.max_depth)
        out["differing_mirror_words"] = int(
            (cache.values[lo:] != one.values[lo:]).sum()
            + (cache.occ != one.occ).sum() + (cache.dist != one.dist).sum())
        ref = hybrid.render_cone_hybrid(
            leaves, one, p0.center, p0.half_size, pose, fx, fy, spec=spec,
            depth=cfg.max_depth, dist_level=lvl, max_range=cfg.max_range,
            start_dist=cfg.start_dist, band_cap=cfg.cone_band_cap,
            band_iters=cfg.cone_band_iters, crawl=cfg.cone_band_crawl,
            fused_dist=cfg.cone_band_fused_dist,
            depth_prio=cfg.cone_band_depth_prio,
            compact_after=cfg.cone_band_compact_after)
        d = (fb[..., :3] - ref[..., :3]).abs()
        out["pixels_off_1e-5"] = float((d.max(-1).values > 1e-5)
                                       .float().mean())
        mse = float((d ** 2).mean())
        out["psnr_db"] = 10.0 * math.log10(1.0 / max(mse, 1e-12))
        check(out["differing_mirror_words"] == 0,
              f"[multichip] hybrid: {out['differing_mirror_words']} mirror "
              f"words differ from the rebuilt mirror")
        check(out["pixels_off_1e-5"] < 0.005 and out["psnr_db"] > 40.0,
              f"[multichip] hybrid image: {out}")
    return out


def _multichip_checkpoint(smi: str, state, cfg, mesh, frame):
    """The [multichip] checkpoint step: save_sharded writes the reference
    package's file (n, a0 .. a{n-1}, its 13 stamps), load_sharded brings
    back every word with every shard on its device, and one more frame
    from the loaded state and from a copy of the original alike."""
    from octree_slam_tpu_torch import convert
    from octree_slam_tpu_torch.app import _flatten
    from octree_slam_tpu_torch.parallel import distributed, run2d
    names = convert.state2d_leaf_names(cfg)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "smap.npz")
        t0 = time.perf_counter()
        run2d.save_sharded(path, state, cfg)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        keys_off = _key_set_off(path, len(names), REFERENCE_SHARDED_STAMPS)
        t0 = time.perf_counter()
        loaded, lcfg = run2d.load_sharded(path, cfg, mesh)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    a = _flatten(convert.state2d_to_numpy(state))
    b = _flatten(convert.state2d_to_numpy(loaded))
    on_device = all(p.child.device == lv.keys.device == dev
                    for dev, p, lv in zip(mesh.axis_devices("map"),
                                          loaded.smap.pools,
                                          loaded.smap.leaves))
    step = distributed.slam_step_2d(lcfg, mesh)
    sa, _ = step(convert.clone_state(state), frame)
    sb, _ = step(loaded, frame)
    ka, va = run2d.union_leaves(sa.smap)
    kb, vb = run2d.union_leaves(sb.smap)
    ck = {"arrays": len(names), "keys_off_reference": keys_off,
          "fields": len(a), "file_bytes": size, "save_s": t_save,
          "load_s": t_load, "shards_on_their_devices": on_device,
          "differing_words": sum(int(np.count_nonzero(a[k] != b[k]))
                                 for k in a if k in b and
                                 a[k].shape == b[k].shape),
          "next_frame_equal": bool(torch.equal(sa.pose, sb.pose)
                                   and np.array_equal(ka, kb)
                                   and np.array_equal(va, vb))}
    print(f"[multichip] checkpoint {smi} | " + json.dumps(ck))
    check(not keys_off and lcfg == cfg and on_device,
          f"[multichip] checkpoint: {ck}")
    check(a.keys() == b.keys() and ck["differing_words"] == 0,
          f"[multichip] checkpoint: {ck}")
    check(ck["next_frame_equal"],
          "[multichip] checkpoint: the next frame differs")


def phase_multichip(smi: str, cfg, frames, gts, splat_registry):
    """Phase 17: run_slam_2d, the app loop on the 2-D ("px", "map") mesh,
    at full width on the card: the map axis alone against the splat orbit
    bit for bit; the rows split in two for each render against the orbit
    within the stated pose tolerance and the pinned ATE; a run that grows
    and rebalances against a single pool fed its own poses; the sharded
    tiering round trip; the checkpoint round trip; a recovery. Returns the
    kernels' launches of the (2, 4) splat run."""
    from octree_slam_tpu_torch import convert, pipeline
    from octree_slam_tpu_torch.map import svo, tiering
    from octree_slam_tpu_torch.parallel import distributed, run2d, tiering2d
    from octree_slam_tpu_torch.render import splat
    from octree_slam_tpu_torch.sensor import tracking
    gts_np = [g.cpu().numpy() for g in gts]
    t_phase = time.perf_counter()
    print(f"[multichip] {smi} | torch.cuda.device_count() "
          f"{torch.cuda.device_count()}")

    # the single-device orbit: poses and map of pipeline.step("splat")
    ref = pipeline.init_state(cfg, initial_pose=gts[0], device="cuda")
    ref_poses = []
    for f in frames:
        ref, out = pipeline.step(ref, f, cfg)
        ref_poses.append(out.pose)
    ref_poses = torch.stack(ref_poses).cpu().numpy()
    ref_k, ref_v = (x.numpy() for x in _sorted_registry(ref))
    check(np.array_equal(ref_k, splat_registry[0].numpy())
          and np.array_equal(ref_v, splat_registry[1].numpy()),
          "[multichip] the single-device orbit's registry moved")

    def union_off(smap):
        k, v = run2d.union_leaves(smap)
        if k.shape != ref_k.shape or not np.array_equal(k, ref_k):
            return int(np.setxor1d(k, ref_k).size)
        return int(np.count_nonzero(v != ref_v.view(np.uint32)))

    reports = {}
    # 1. the map axis alone: the single-device tracker, bit for bit
    mesh = distributed.make_mesh2(*MULTICHIP_MESHES[0])
    print(f"[multichip] mesh {mesh.shape}: map shards on "
          f"{[str(d) for d in mesh.axis_devices('map')]}, row slabs on "
          f"{[str(d) for d in mesh.axis_devices('px')]}")
    state, _, info, rep = _run_2d(cfg, mesh, frames, gts, "splat")
    pose = torch.from_numpy(info["poses"][-1]).cuda()
    zb = distributed.model_zbuffer_sharded(state.smap, pose, cfg, mesh)
    live = (torch.arange(ref.leaves.keys.shape[0], device="cuda")
            < ref.leaves.count) & (ref.leaves.keys >= 0)
    zb1 = splat.splat_zbuffer(
        ref.leaves.vals, ref.leaves.keys, live, ref.pool.center,
        ref.pool.half_size, pose, cfg.focal_x, cfg.focal_y, width=cfg.width,
        height=cfg.height, depth=cfg.max_depth, max_range=cfg.max_range)
    rep.update(poses_equal=bool(np.array_equal(info["poses"], ref_poses)),
               union_leaves_differing=union_off(state.smap),
               zbuffer_words_differing=int((zb != zb1).sum()),
               ate_rmse_m=_orbit_ate(list(info["poses"]), gts_np))
    reports["1x8 splat"] = rep
    print(f"[multichip] {smi} | " + json.dumps(rep))
    check(rep["poses_equal"], "[multichip] 1x8: poses differ from the orbit")
    check(rep["union_leaves_differing"] == 0,
          f"[multichip] 1x8: {rep['union_leaves_differing']} union leaves "
          f"differ from the orbit's registry")
    check(rep["zbuffer_words_differing"] == 0,
          "[multichip] 1x8: the packed z-buffer differs")
    for name in KERNELS:
        check(rep["launches"][name] == ORBIT_FRAMES,
              f"[multichip] 1x8: {name} launched {rep['launches'][name]}")
    del state

    # 2. rows in two slabs: the pyramid of every frame bit for bit
    mesh = distributed.make_mesh2(*MULTICHIP_MESHES[1])
    print(f"[multichip] mesh {mesh.shape}: map shards on "
          f"{[str(d) for d in mesh.axis_devices('map')]}, row slabs on "
          f"{[str(d) for d in mesh.axis_devices('px')]} rows "
          f"{[s.rows for s in distributed.frame_sharding(mesh, cfg)]}, "
          f"halo {distributed.pyramid_halo(cfg)}")
    sensor = distributed.row_sharded_sensor(cfg, mesh)
    off = 0
    for f in frames:
        whole, _ = sensor(f)
        for a, b in zip(whole, tracking.build_pyramid(f.depth, f.color, cfg)):
            off += sum(int((x != y).sum()) for x, y in zip(a, b))
    print(f"[multichip] slab pyramids of {len(frames)} frames: {off} "
          f"values differ from the whole frame's")
    check(off == 0, f"[multichip] {off} slab pyramid values differ")
    launches = None
    for render in ("splat", "cone", "cone_hybrid"):
        rcfg = dataclasses.replace(cfg, **HYBRID_BAND) \
            if render == "cone_hybrid" else cfg
        state, _, info, rep = _run_2d(rcfg, mesh, frames, gts, render)
        pose = torch.from_numpy(info["poses"][-1]).cuda()
        fb = {"splat": distributed.render_sharded_map,
              "cone": distributed.render_sharded_cone,
              "cone_hybrid": distributed.render_sharded_hybrid}[render](
            state.smap, pose, rcfg.focal_x, rcfg.focal_y, rcfg, mesh)
        rep.update(
            pose_max_abs_diff=float(np.abs(info["poses"] - ref_poses).max()),
            ate_rmse_m=_orbit_ate(list(info["poses"]), gts_np),
            union_leaves_differing=union_off(state.smap),
            **_render_checks(state.smap, pose, rcfg, mesh, render, fb))
        reports[f"2x4 {render}"] = rep
        print(f"[multichip] {smi} | " + json.dumps(rep))
        check(rep["pose_max_abs_diff"] <= MULTICHIP_POSE_TOL,
              f"[multichip] 2x4 {render}: poses off by "
              f"{rep['pose_max_abs_diff']}")
        check(abs(rep["ate_rmse_m"] - ORBIT_ATE_M) <= MULTICHIP_ATE_TOL_M,
              f"[multichip] 2x4 {render}: ATE {rep['ate_rmse_m']:.9f} m")
        for name in KERNELS:
            check(rep["launches"][name] == 2 * ORBIT_FRAMES,
                  f"[multichip] 2x4 {render}: {name} launched "
                  f"{rep['launches'][name]}, expected 2 a frame")
        if render == "splat":
            launches = rep["launches"]
            splat_state = state
        del state

    # 3. growth and rebalancing, against one pool fed the run's poses
    # registries of 4,096 rows overflow on the first frame and grow; the
    # pools have room for any shard's share
    gcfg = dataclasses.replace(cfg, map_split_level=2,
                               node_capacity=1 << 19, leaf_capacity=1 << 12)
    state, gcfg2, info, rep = _run_2d(gcfg, mesh, frames, gts, "splat",
                                      rebalance_factor=1.1)
    one = svo.create(cfg.node_capacity, state.smap.pools[0].center,
                     state.smap.pools[0].half_size, device="cuda")
    reg = splat.create_leaf_list(cfg.leaf_capacity, cfg.node_capacity,
                                 device="cuda")
    for f, p in zip(frames, info["poses"]):
        p = torch.from_numpy(p).cuda()
        v = tracking.build_pyramid(f.depth, f.color, cfg)[0].vertex
        wp = v.reshape(-1, 3) @ p[:3, :3].T + p[:3, 3]
        lk = None
        while True:
            one, st = svo.insert(one, wp, pipeline._fuse_colors(f, cfg),
                                 depth=cfg.max_depth,
                                 unique_cap=cfg.insert_unique_cap, min_key=lk)
            reg = splat.append_new_leaves(reg, st)
            if not bool(st.unique_overflow):
                break
            lk = st.last_key
    k1, v1 = distributed.registry_rows(reg)
    o = np.argsort(k1, kind="stable")
    k1, v1 = k1[o], v1[o]
    k2, v2 = run2d.union_leaves(state.smap)
    rep.update(node_capacity=gcfg2.node_capacity,
               leaf_capacity=gcfg2.leaf_capacity,
               any_overflow=bool(any(bool(p.overflowed)
                                     for p in state.smap.pools)
                                 or any(bool(lv.overflowed)
                                        for lv in state.smap.leaves)),
               union_equals_replay=bool(np.array_equal(k1, k2)
                                        and np.array_equal(v1, v2)),
               bounds=state.smap.bounds.tolist())
    reports["2x4 grow"] = rep
    print(f"[multichip] {smi} | " + json.dumps(rep))
    check("grow" in rep["events"] and "rebalance" in rep["events"],
          f"[multichip] the growth run's events {rep['events']}")
    check(not rep["any_overflow"], "[multichip] the growth run overflowed")
    check(rep["union_equals_replay"],
          "[multichip] the growth run's union differs from the replay")
    del state, one, reg

    # 4. tiering: every leaf spilled (camera far) and restored
    smap = splat_state.smap
    k0, v0 = run2d.union_leaves(smap)
    tcfg = dataclasses.replace(cfg, restore_radius=1e6)
    archive = tiering.HostArchive(tcfg.tier_level)
    t0 = time.perf_counter()
    smap, n_spill = tiering2d.spill_cold_sharded(
        smap, tcfg, mesh, archive, camera_pos=gts_np[-1][:3, 3] + 1000.0)
    torch.cuda.synchronize()
    t_spill = time.perf_counter() - t0
    left = int(distributed.shard_leaf_counts(smap).sum())
    t0 = time.perf_counter()
    smap, tcfg2, n_rest = tiering2d.restore_due_sharded(
        smap, tcfg, mesh, archive, camera_pos=gts_np[-1][:3, 3])
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    k1, v1 = run2d.union_leaves(smap)
    tier = {"leaves": int(k0.size), "spilled": n_spill, "left": left,
            "restored": n_rest, "spill_s": t_spill, "restore_s": t_restore,
            "differing_leaf_words": (int(np.count_nonzero(v0 != v1))
                                     if np.array_equal(k0, k1) else -1)}
    print(f"[multichip] tiering {smi} | " + json.dumps(tier))
    check(n_spill == k0.size and left == 0 and n_rest == k0.size,
          f"[multichip] tiering moved {tier}")
    check(tier["differing_leaf_words"] == 0,
          f"[multichip] tiering: {tier['differing_leaf_words']} words differ")

    # 5. the checkpoint round trip, in the reference package's file
    _multichip_checkpoint(smi, splat_state._replace(smap=smap), tcfg2, mesh,
                          frames[-1])
    del splat_state, smap

    # 6. recovery: frame RELOC_GARBAGE_FRAME blanked
    rcfg = dataclasses.replace(cfg, keypose_every=2,
                               reloc_candidates=RELOC_CANDIDATES)
    bad = list(frames)
    f = bad[RELOC_GARBAGE_FRAME]
    bad[RELOC_GARBAGE_FRAME] = type(f)(torch.zeros_like(f.depth),
                                       torch.zeros_like(f.color), f.timestamp)
    state, _, info, rep = _run_2d(rcfg, mesh, bad, gts, "splat")
    rep["last_frame_translation_err_m"] = float(np.linalg.norm(
        info["poses"][-1][:3, 3] - gts_np[-1][:3, 3]))
    rep["diverged"] = bool(state.diverged)
    print(f"[multichip] relocalize {smi} | " + json.dumps(rep))
    check("relocalize" in rep["events"] and not rep["diverged"]
          and rep["last_frame_translation_err_m"] < RELOC_ERR_MAX_M,
          f"[multichip] no recovery: {rep}")
    del state
    print(f"[multichip] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


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
                    choices=("splat", "cone", "cone_march", "cone_hybrid",
                             "offline"),
                    help="profile one extra frame of this render by kernel "
                         "(torch.profiler) and count its host reads; "
                         "offline profiles the 256^3 voxelization, the "
                         "A-buffer and the 640x480 raster instead")
    args = ap.parse_args(argv)
    smi = phase_device()
    phase_build()
    report = phase_kernels()
    cfg = _bench_config()
    frames, gts = _orbit(cfg, ORBIT_FRAMES, 0.01, "cuda")
    launches = {}
    launches["splat"], state, splat_res = phase_orbit(
        smi, cfg, frames, gts, "splat", args.profile)
    splat_registry = _sorted_registry(state)
    del state
    phase_reference()
    hybrid_cfg = dataclasses.replace(cfg, **HYBRID_BAND)
    for render in ("cone", "cone_march", "cone_hybrid"):
        launches[render], _, hybrid_res = phase_orbit(
            smi, hybrid_cfg if render == "cone_hybrid" else cfg, frames, gts,
            render, args.profile)
    launches.update(phase_features(smi, cfg, frames, gts, splat_registry))
    fidelity = phase_fidelity(smi, cfg, hybrid_cfg, frames, gts)
    state, app_cfg, launches["app"] = phase_app(smi, cfg, frames, gts)
    phase_checkpoint(smi, state, app_cfg, frames, gts)
    phase_tiering(smi, state, app_cfg)
    del state
    launches["grow"] = phase_grow(smi, cfg, frames, gts, splat_registry,
                                  splat_res["map_size_by_frame"])
    launches["relocalize"] = phase_relocalize(smi, cfg, frames, gts)
    launches["tum"] = phase_tum(smi)
    launches["multichip"] = phase_multichip(smi, cfg, frames, gts,
                                            splat_registry)
    launches["offline"] = phase_offline(smi, args.profile)
    window = f"splat+bilateral{WINDOW_SIZE}"
    report[WINDOW_KERNEL], launches[window] = phase_knobs(
        smi, cfg, hybrid_cfg, frames, gts, fidelity)
    phase_fuzz_map(smi)
    # each kernel's main path: the splat orbit at the window that runs it
    main_path = {name: "splat" for name in KERNELS}
    main_path[WINDOW_KERNEL] = window
    replaces = {name: spec["replaces"] for name, spec in KERNELS.items()}
    replaces[WINDOW_KERNEL] = WINDOW_REPLACES
    # no single PyTorch call computes any of them, so library_ms is null
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": replaces[name], "main_path": path,
                "launches": launches[path][name],
                "launches_per_frame": launches[path][name] / ORBIT_FRAMES,
                "launches_by_path": {p: n.get(name, 0)
                                     for p, n in launches.items()},
                # the recovery pyramid's launches take the candidates as
                # one batch
                "relocalize_launch_batch": RELOC_CANDIDATES,
                **report[name]} for name, path in main_path.items()]
    kernels.append({"name": "band_march", "route": "cuda",
                    "source": BAND_SOURCE, "replaces": BAND_REPLACES,
                    "main_path": "cone_hybrid",
                    "launches": hybrid_res["band_launches"],
                    "launches_per_frame": hybrid_res["band_launches"]
                    / ORBIT_FRAMES, **hybrid_res["band_march"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
