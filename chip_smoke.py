"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the whole check, one card
    python3 chip_smoke.py --profile    # also profile one splat frame by kernel
    python3 chip_smoke.py --profile cone         # ... one slab-cone frame
    python3 chip_smoke.py --profile cone_march   # ... one exact-march frame
    python3 chip_smoke.py --profile cone_hybrid  # ... one hybrid frame

Phases, each of which raises on failure (non-zero exit, no result line):
  1. device: a CUDA card of compute capability 9.0, strict float32 matmuls;
  2. build: compile the port's kernels from octree_slam_tpu_torch/csrc;
  3. kernel vs plain: each hand-written kernel against its plain PyTorch
     version on the card, bit for bit, with both times: per call including
     the launch (CUDA events, median of 50) and on the device alone
     (torch.profiler, mean of 50), beside the kernel's bound (the larger of
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
     word buffer; then a stream with the keyframe anchor, the saturation
     gate and the directory cache on, rendered by the hybrid, on both;
  6. the slab cone at full width: the same orbit through step("cone");
  7. the exact march at full width: the same orbit through
     step("cone_march"), every frame eager, with the march's trip counts
     and the peak device memory;
  8. the hybrid at full width: the same orbit through step("cone_hybrid")
     with bench.py's band (57,600 lanes, 24 trips), every frame lazy; at
     most 3 host reads a frame; afterwards the mirror it kept must equal,
     word for word, one rebuilt from the pool and stamped; the band's size,
     the share of its rays still active at the trip cap and the peak
     device memory are printed;
  9. the step features at full width: the splat orbit with the insert's
     directory cache on must end with the splat orbit's leaf registry,
     node count and ATE; the orbit with the keyframe anchor and the
     saturation gate on must not diverge, keep its ATE under 0.01 m and
     end with the mask that rebuild_sat_mask makes;
 10. fidelity, as bench.py measures it: a map built by 13 splat frames,
     the last frame rendered by the slab cone, the exact march and the
     hybrid from copies of the state, and the two PSNRs against the march
     (cone_psnr_db, cone_hybrid_psnr_db: the hybrid's must be the higher);
     then that heal_for_march is idempotent.
Every orbit starts with the kernels' launch counts at 0 and must find each
kernel launched once per frame. The last lines are the card's name and
power limit, a JSON line of the kernels, and {"ok": true, "device":
{...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import subprocess
import time
import warnings

import numpy as np
import torch

# Both kernels follow their plain versions op for op (same tap order, expf,
# IEEE division, rintf / truncation, no FMA contraction), so the tolerance
# is 0 mm: every output pixel must be equal. Each case is (shape, levels);
# the first is the main path's, and its times go into the JSON line.
KERNELS = {
    "bilateral7x7": {
        "replaces": "octree_slam_tpu/sensor/pallas_ops.py:149",
        "cases": [((480, 640), None), ((1080, 1920), None),
                  ((479, 641), None), ((483, 645), None),
                  ((4, 240, 320), None), ((2, 1080, 1920), None)],
    },
    "gated_pyramid5x5": {
        "replaces": "octree_slam_tpu/sensor/pallas_ops.py:160",
        "cases": [((480, 640), 2), ((479, 641), 2), ((483, 645), 2),
                  ((4, 240, 320), 2), ((480, 640), 1), ((240, 320), 1)],
    },
}
SOURCE = "octree_slam_tpu_torch/csrc/sensor_stencils.cu"
# the H100 SXM's published peaks (NVIDIA data sheet, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# the 14-frame orbit's result since PR 1; the kernels are bit-exact against
# their plain versions, so any change in it is a fault
ORBIT_ATE_M, ORBIT_ATE_TOL_M = 0.0018455, 1e-7
ORBIT_MAP_NODES, ORBIT_MAP_LEAVES = 425_760, 73_458
ORBIT_FRAMES, ORBIT_WARMUP = 14, 2
# the slab cone against the exact march on one map, in dB
CONE_PSNR_FLOOR_DB = 25.0
# bench.py's hybrid arm: the band's lanes and its trip cap
HYBRID_BAND = {"cone_band_cap": 57_600, "cone_band_iters": 24}
# a feature orbit's own trajectory bound (the verify skill's good output)
FEATURE_ATE_MAX_M = 0.01


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
    d = torch.randint(400, 6000, shape, generator=gen, device="cuda",
                      dtype=torch.int32)
    holes = torch.rand(shape, generator=gen, device="cuda") < 0.1
    return torch.where(holes, 0, d).contiguous()


def _window_taps(n: int, half: int, step: int) -> int:
    """In-image taps along one axis of a (2 half + 1)-wide window centred
    on every `step`-th pixel of an n-pixel axis (whose output has n // step
    pixels when step > 1)."""
    centres = range(0, step * (n // step), step) if step > 1 else range(n)
    return sum(1 for c in centres for d in range(-half, half + 1)
               if 0 <= c + d < n)


def bilateral_work(shape):
    """(bytes, float32 operations) of one bilateral7x7 call: the input read
    and the output written once; per in-image tap a subtract, two
    multiplies, an add, the exp, a multiply and two adds (8), and a divide
    and a round per pixel."""
    b, h, w = (1, *shape) if len(shape) == 2 else shape
    taps = b * _window_taps(h, 3, 1) * _window_taps(w, 3, 1)
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


def _case_calls(name, levels):
    """(kernel, plain, work) for one case: callables of a depth tensor
    returning a list of outputs, and the bound's (bytes, operations)."""
    from octree_slam_tpu_torch.sensor import cuda_ops
    if name == "bilateral7x7":
        return (lambda d: [cuda_ops.bilateral(d, 4.5, 40.0)],
                lambda d: [cuda_ops.bilateral_plain(d, 4.5, 40.0)],
                bilateral_work)
    return (lambda d: cuda_ops.gated_pyramid(d, 120.0, levels),
            lambda d: cuda_ops.gated_pyramid_plain(d, 120.0, levels),
            lambda shape: gated_pyramid_work(shape, levels))


def phase_kernels():
    from octree_slam_tpu_torch.utils.timing import device_ms, median_ms
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {}
    for name, spec in KERNELS.items():
        worst = 0
        for i, (shape, levels) in enumerate(spec["cases"]):
            kernel, plain, work = _case_calls(name, levels)
            d = _depth(shape, gen)
            outs, refs = kernel(d), plain(d)
            torch.cuda.synchronize()
            label = f"{name} {shape}" + (f" levels {levels}" if levels else "")
            check(len(outs) == len(refs), f"{label}: {len(outs)} outputs")
            n_off = n_all = 0
            for out, ref in zip(outs, refs):
                check(out.shape == ref.shape and out.dtype == ref.dtype,
                      f"{label}: {tuple(out.shape)} vs {tuple(ref.shape)}")
                diff = (out.to(torch.int64) - ref).abs()
                if diff.numel():
                    worst = max(worst, int(diff.max()))
                n_off += int((diff > 0).sum())
                n_all += diff.numel()
            ms = median_ms(lambda: kernel(d), runs=50)
            pms = median_ms(lambda: plain(d), runs=50)
            dms = device_ms(lambda: kernel(d), runs=50)
            pdms = device_ms(lambda: plain(d), runs=50)
            bms, by = bound(*work(shape))
            print(f"[kernel] {label}: {n_off} of {n_all} pixels differ | "
                  f"per call incl. launch (median of 50): kernel {ms:.4f} "
                  f"ms, plain {pms:.4f} ms | device only (mean of 50): "
                  f"kernel {dms:.4f} ms, plain {pdms:.4f} ms | bound "
                  f"{bms:.5f} ms ({by}), {100 * bms / dms:.1f}% of it on "
                  f"the device")
            check(n_off == 0,
                  f"{label}: {n_off} of {n_all} pixels differ from the plain "
                  f"version, tolerance 0 mm")
            if i == 0:
                report[name] = {"ms": ms, "plain_ms": pms, "device_ms": dms,
                                "plain_device_ms": pdms, "bound_ms": bms,
                                "bound_by": by, "library_ms": None}
        report[name]["max_abs_err"] = worst
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
    from octree_slam_tpu_torch.sensor import cuda_ops
    from octree_slam_tpu_torch.utils.metrics import ate_rmse
    from octree_slam_tpu_torch.utils.timing import EventTimer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    state = pipeline.init_state(cfg, initial_pose=gts[0], device="cuda")
    for i in range(ORBIT_WARMUP):
        state, out = pipeline.step(state, frames[i], cfg, render=render)
    timer = EventTimer()
    est = []
    for i in range(ORBIT_WARMUP, len(frames) - 1):
        with timer.time("frame"):
            state, out = pipeline.step(state, frames[i], cfg, render=render)
        est.append(out.pose)
    with _HostReads() as reads, timer.time("frame"):
        state, out = pipeline.step(state, frames[-1], cfg, render=render)
    est.append(out.pose)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)

    ms = timer.ms("frame")
    fb = out.framebuffer
    res = {
        "render": render, "path": label,
        "frame_ms_median": statistics.median(ms),
        "frame_ms_p90": float(np.percentile(ms, 90)),
        "fps": 1000.0 * len(ms) / sum(ms),
        "ate_rmse_m": ate_rmse(
            np.stack([p.cpu().numpy() for p in est]),
            np.stack([g.cpu().numpy() for g in gts[ORBIT_WARMUP:]])),
        "map_nodes": int(out.map_nodes), "map_leaves": int(out.map_leaves),
        "diverged": bool(out.diverged),
        "map_overflowed": bool(out.map_overflowed),
        "fb_hit_pixels": int((fb[..., :3].sum(-1) > 0).sum()),
        "launches": launches, "host_reads_last_frame": reads.count,
        "wall_s_with_warmup": wall,
        "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20,
    }
    return state, out, res


def _check_orbit(smi: str, cfg, out, res, n_frames: int, pinned: bool):
    """The checks every orbit must pass, whatever its render. `pinned`
    holds the trajectory and the map to the main orbit's values; an orbit
    that tracks another way (the keyframe anchor) has its own trajectory
    and is held to FEATURE_ATE_MAX_M."""
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
        # fusion does not depend on the render: every orbit builds one map
        check(abs(res["ate_rmse_m"] - ORBIT_ATE_M) <= ORBIT_ATE_TOL_M,
              f"{tag} ATE {res['ate_rmse_m']:.9f} m, expected {ORBIT_ATE_M} "
              f"+- {ORBIT_ATE_TOL_M} m")
        check(res["map_nodes"] == ORBIT_MAP_NODES,
              f"{tag} map nodes {res['map_nodes']}, expected "
              f"{ORBIT_MAP_NODES}")
        check(res["map_leaves"] == ORBIT_MAP_LEAVES,
              f"{tag} map leaves {res['map_leaves']}, expected "
              f"{ORBIT_MAP_LEAVES}")
    else:
        check(res["ate_rmse_m"] < FEATURE_ATE_MAX_M,
              f"{tag} ATE {res['ate_rmse_m']:.6f} m, expected under "
              f"{FEATURE_ATE_MAX_M} m")
        check(res["map_leaves"] > ORBIT_MAP_LEAVES // 2,
              f"{tag} map leaves {res['map_leaves']}")
    check(res["fb_hit_pixels"] > 0, f"{tag} framebuffer has no lit pixels")
    for name in KERNELS:
        check(res["launches"][name] == n_frames,
              f"{tag} {name} launches {res['launches'][name]} != {n_frames}")


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
            "rays_unfinished": int((dbg["fin"] >= cfg.max_march_iters).sum())}


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


def phase_orbit(smi: str, cfg, frames, gts, render: str, profile,
                label: str | None = None, pinned: bool = True,
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
        label="splat+keyframe+gate", pinned=False)
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
    of heal_for_march."""
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
    hybrid from copies of both states, then the stream once more with the
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
    cfg = _bench_config()
    frames, gts = _orbit(cfg, ORBIT_FRAMES, 0.01, "cuda")
    launches = {}
    launches["splat"], state, _ = phase_orbit(smi, cfg, frames, gts, "splat",
                                              args.profile)
    splat_registry = _sorted_registry(state)
    del state
    phase_reference()
    hybrid_cfg = dataclasses.replace(cfg, **HYBRID_BAND)
    for render in ("cone", "cone_march", "cone_hybrid"):
        launches[render], _, _ = phase_orbit(
            smi, hybrid_cfg if render == "cone_hybrid" else cfg, frames, gts,
            render, args.profile)
    launches.update(phase_features(smi, cfg, frames, gts, splat_registry))
    phase_fidelity(smi, cfg, hybrid_cfg, frames, gts)
    # no single PyTorch call computes either function, so library_ms is null
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": spec["replaces"],
                "launches": launches["splat"][name],
                "launches_per_frame": launches["splat"][name] / ORBIT_FRAMES,
                "launches_by_path": {path: n[name]
                                     for path, n in launches.items()},
                **report[name]} for name, spec in KERNELS.items()]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
