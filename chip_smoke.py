"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the whole check, one card
    python3 chip_smoke.py --profile    # also profile one frame by kernel

Phases, each of which raises on failure (non-zero exit, no result line):
  1. device: a CUDA card of compute capability 9.0, strict float32 matmuls;
  2. build: compile the port's kernels from octree_slam_tpu_torch/csrc;
  3. kernel vs plain: each hand-written kernel against its plain PyTorch
     version on the card, bit for bit, with both times: per call including
     the launch (CUDA events, median of 50) and on the device alone
     (torch.profiler, mean of 50);
  4. main path: the 14-frame synthetic orbit of bench.py (640x480, depth 9,
     2 cm leaves) through pipeline.init_state + pipeline.step("splat"),
     with per-frame CUDA-event times, ATE, map size and launch counts;
  5. reference: a small stream through the same step on the card and on
     the CPU (the plain versions the CPU tests hold against the JAX
     package) must agree.
The last lines are the card's name and power limit, a JSON line of the
kernels, and {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import time

import numpy as np
import torch

# Both kernels follow their plain versions op for op (same tap order, expf,
# IEEE division, rintf / truncation, no FMA contraction), so the tolerance
# is 0 mm: every output pixel must be equal.
KERNELS = {
    "bilateral7x7": {
        "replaces": "octree_slam_tpu/sensor/pallas_ops.py:149",
        "shapes": [(480, 640), (1080, 1920), (479, 641), (4, 240, 320)],
    },
    "gated_subsample5x5": {
        "replaces": "octree_slam_tpu/sensor/pallas_ops.py:160",
        "shapes": [(480, 640), (240, 320), (479, 641)],
    },
}
SOURCE = "octree_slam_tpu_torch/csrc/sensor_stencils.cu"


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


def phase_kernels():
    from octree_slam_tpu_torch.sensor import cuda_ops
    from octree_slam_tpu_torch.utils.timing import device_ms, median_ms
    calls = {
        "bilateral7x7": (lambda d: cuda_ops.bilateral(d, 4.5, 40.0),
                         lambda d: cuda_ops.bilateral_plain(d, 4.5, 40.0)),
        "gated_subsample5x5": (
            lambda d: cuda_ops.gated_subsample(d, 120.0),
            lambda d: cuda_ops.gated_subsample_plain(d, 120.0)),
    }
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {}
    for name, spec in KERNELS.items():
        kernel, plain = calls[name]
        worst = 0
        for shape in spec["shapes"]:
            d = _depth(shape, gen)
            out, ref = kernel(d), plain(d)
            torch.cuda.synchronize()
            check(out.shape == ref.shape and out.dtype == ref.dtype,
                  f"{name} {shape}: {tuple(out.shape)} vs {tuple(ref.shape)}")
            diff = (out.to(torch.int64) - ref).abs()
            err, n_off = int(diff.max()), int((diff > 0).sum())
            worst = max(worst, err)
            ms = median_ms(lambda: kernel(d), runs=50)
            pms = median_ms(lambda: plain(d), runs=50)
            dms = device_ms(lambda: kernel(d), runs=50)
            pdms = device_ms(lambda: plain(d), runs=50)
            print(f"[kernel] {name} {shape}: max|d| {err} mm, {n_off} of "
                  f"{diff.numel()} pixels differ | per call incl. launch "
                  f"(median of 50): kernel {ms:.4f} ms, plain {pms:.4f} ms | "
                  f"device only (mean of 50): kernel {dms:.4f} ms, plain "
                  f"{pdms:.4f} ms")
            check(n_off == 0,
                  f"{name} {shape}: {n_off} of {diff.numel()} pixels differ "
                  f"from the plain version (max {err} mm), tolerance 0 mm")
            if shape == spec["shapes"][0]:
                report[name] = {"ms": ms, "plain_ms": pms, "device_ms": dms,
                                "plain_device_ms": pdms}
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


def phase_main_path(smi: str, profile: bool):
    from octree_slam_tpu_torch import pipeline
    from octree_slam_tpu_torch.sensor import cuda_ops
    from octree_slam_tpu_torch.utils.metrics import ate_rmse
    from octree_slam_tpu_torch.utils.timing import EventTimer
    cfg = _bench_config()
    n_stream, n_warmup = 14, 2
    frames, gts = _orbit(cfg, n_stream, 0.01, "cuda")
    torch.cuda.synchronize()

    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    state = pipeline.init_state(cfg, initial_pose=gts[0], device="cuda")
    for i in range(n_warmup):
        state, out = pipeline.step(state, frames[i], cfg, render="splat")
    timer = EventTimer()
    est = []
    for i in range(n_warmup, n_stream):
        with timer.time("frame"):
            state, out = pipeline.step(state, frames[i], cfg, render="splat")
        est.append(out.pose)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)

    ms = timer.ms("frame")
    med = statistics.median(ms)
    p90 = float(np.percentile(ms, 90))
    ate = ate_rmse(np.stack([p.cpu().numpy() for p in est]),
                   np.stack([g.cpu().numpy() for g in gts[n_warmup:]]))
    fb = out.framebuffer
    res = {
        "frame_ms_median": med, "frame_ms_p90": p90,
        "fps": 1000.0 * len(ms) / sum(ms), "ate_rmse_m": ate,
        "map_nodes": int(out.map_nodes), "map_leaves": int(out.map_leaves),
        "diverged": bool(out.diverged),
        "map_overflowed": bool(out.map_overflowed),
        "fb_hit_pixels": int((fb[..., 3] > 0).sum()),
        "launches": launches, "wall_s_with_warmup": wall,
        "peak_mem_mb": torch.cuda.max_memory_allocated() / 2**20,
    }
    print(f"[main] {smi} | 640x480 depth 9 2 cm, {len(ms)} timed frames "
          f"after {n_warmup} warm-up | frame ms median {med:.3f} p90 "
          f"{p90:.3f} | {res['fps']:.2f} frames/s")
    print(f"[main] {smi} | " + json.dumps(res))
    check(fb.shape == (cfg.height, cfg.width, 4)
          and bool(torch.isfinite(fb).all()), "framebuffer shape/finiteness")
    check(not res["diverged"], "tracking diverged")
    check(not res["map_overflowed"], "map overflowed")
    check(ate < 0.01, f"ATE {ate:.5f} m >= 0.01 m")
    check(res["map_leaves"] > 0, "no leaves fused")
    check(res["fb_hit_pixels"] > 0, "framebuffer has no hit pixels")
    check(launches["bilateral7x7"] == n_stream,
          f"bilateral launches {launches['bilateral7x7']} != {n_stream}")
    check(launches["gated_subsample5x5"] == 2 * n_stream,
          f"gated launches {launches['gated_subsample5x5']} != "
          f"{2 * n_stream}")
    if profile:
        _profile_frame(state, frames[-2:], cfg, med)
    return launches


def _profile_frame(state, frames, cfg, frame_ms):
    """torch.profiler over the last of `frames` (the first warms the
    profiler up): host time per step stage, device time per kernel, and
    the CUDA runtime calls (launches, syncs, copies) by host time. The
    device's idle share is taken against `frame_ms`, the frame median
    measured without the profiler, which slows the host."""
    from torch.profiler import ProfilerActivity, profile, schedule
    from octree_slam_tpu_torch import pipeline
    walls, captured = [], []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: captured.append(
                     p.key_averages())) as prof:
        for frame in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = pipeline.step(state, frame, cfg, render="splat")
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
    print(f"[profile] one frame: device busy {busy:.3f} ms, "
          f"{sum(e.count for e in kernels)} kernels | frame median without "
          f"the profiler {frame_ms:.3f} ms, so the device is idle "
          f"{100 * (1 - busy / frame_ms):.1f}% of it | host wall of the "
          f"profiled frame {walls[-1]:.3f} ms")
    for e in ranges:
        if e.key.startswith("step.") and e.cpu_time_total > 0:
            print(f"[profile]   range {e.key:13s} host {e.cpu_time_total / 1e3:8.3f}"
                  f" ms")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:12]:
        print(f"[profile]   kernel {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:<5d} {e.key[:80]}")
    for e in sorted((e for e in events if e.key.startswith("cuda")),
                    key=lambda e: e.cpu_time_total, reverse=True)[:8]:
        print(f"[profile]   runtime {e.cpu_time_total / 1e3:8.3f} ms host "
              f"x{e.count:<5d} {e.key}")


def phase_reference():
    """The same small stream through step on the card and on the CPU."""
    import dataclasses
    from octree_slam_tpu_torch import pipeline
    cfg = dataclasses.replace(
        _bench_config(), width=64, height=48, focal_x=55.0, focal_y=55.0,
        pyramid_depth=2, pyramid_iters=(6, 6), voxel_resolution=0.05,
        max_depth=6, node_capacity=1 << 14, leaf_capacity=1 << 12,
        insert_unique_cap=1 << 10)
    frames, gts = _orbit(cfg, 4, 0.015, "cpu")
    outs = {}
    for dev in ("cuda", "cpu"):
        state = pipeline.init_state(cfg, initial_pose=gts[0], device=dev)
        for f in frames:
            f = type(f)(*(x.to(dev) for x in f))
            state, out = pipeline.step(state, f, cfg)
        outs[dev] = out
    g, c = outs["cuda"], outs["cpu"]
    dpose = float((g.pose.cpu() - c.pose).abs().max())
    same = float((torch.round(g.framebuffer.cpu() * 255)
                  == torch.round(c.framebuffer * 255)).all(-1)
                 .float().mean())
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra frame by kernel (torch.profiler)")
    args = ap.parse_args(argv)
    smi = phase_device()
    phase_build()
    report = phase_kernels()
    launches = phase_main_path(smi, args.profile)
    phase_reference()
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": spec["replaces"], "launches": launches[name],
                **report[name]} for name, spec in KERNELS.items()]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
