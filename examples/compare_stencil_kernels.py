"""Time versions of the sensor-stencil source in turns on one card.

    mkdir -p build/base
    git show <commit>:octree_slam_tpu_torch/csrc/sensor_stencils.cu \\
        > build/base/sensor_stencils.cu
    PYTHONPATH=. python examples/compare_stencil_kernels.py --csrc base=build/base
    # the checkout's source with every radius's (kRun, kTileH) set to
    # (4, 8), and with its loop over window rows unrolled twice
    PYTHONPATH=. python examples/compare_stencil_kernels.py \
        --shape r4h8=4x8 --shape r2h16u2=2x16u2

Each `--csrc NAME=DIR` names a directory of kernel sources with the
package's C interface (`_build.load` declares it); each `--shape
NAME=RxH[uU]` is the checkout's own source with every compiled radius's
bilateral instance set to runs of R outputs a thread, blocks of H output
rows and the loop over window rows unrolled U times (1 unless given; 13
unrolls it fully at every radius): the `kWindowShapes` table of
csrc/sensor_stencils.cu, written under build/compare/NAME. The
checkout's own `csrc/` always comes last as "current". Every version is built at once (one nvcc each, in parallel) by
`_build.build`, loaded in turn by `_build.load`, and timed through the
package's own wrappers: `cuda_ops.bilateral` at the 7x7 ("bilateral") and
at each `--window-sizes` size ("window<size>", bilateral_window), and
`cuda_ops.gated_pyramid` with both levels ("gated"). The versions run in
the order given and then back (A, B, B, A), so a drift of clock or power
over the call shows up as a difference between the two runs of one
version. Every version must give the same pixels as the plain versions; a
version without a launcher for a kernel is reported as such. Prints one
line per run and a JSON summary with each version's device times per
kernel, their mean and their spread (largest minus smallest).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from octree_slam_tpu_torch import _build
from octree_slam_tpu_torch.sensor import cuda_ops
from octree_slam_tpu_torch.utils.timing import device_ms, median_ms

SIGMA_SPATIAL, SIGMA_DEPTH, GATE = 4.5, 40.0, 120.0
# the table of (kRun, kTileH, kRowUnroll) by radius in
# csrc/sensor_stencils.cu
SHAPE_TABLE = re.compile(
    r"(constexpr WindowShape kWindowShapes\[kMaxHalf \+ 1\] = \{\s*"
    r"\{0, 0, 0\},)([^;]*)(\};)")
SHAPE_ARG = re.compile(r"(\d+)x(\d+)(?:u(\d+))?$")
VARIANT_DIR = Path("build/compare")


def kernels(window_sizes):
    """name -> (kernel, plain): callables of a depth tensor returning a
    list of outputs."""
    def bilateral(k):
        return (
            lambda d: [cuda_ops.bilateral(d, SIGMA_SPATIAL, SIGMA_DEPTH, k)],
            lambda d: [cuda_ops.bilateral_plain(d, SIGMA_SPATIAL,
                                                SIGMA_DEPTH, k)])

    fns = {"bilateral": bilateral(7)}
    fns.update({f"window{k}": bilateral(k) for k in window_sizes})
    fns["gated"] = (lambda d: cuda_ops.gated_pyramid(d, GATE, 2),
                    lambda d: cuda_ops.gated_pyramid_plain(d, GATE, 2))
    return fns


def shape_variant(name: str, shape: str) -> Path:
    """A copy of the checkout's csrc/ under build/compare/<name> with every
    compiled radius's instance set to `shape`, "RUNxTILEH[uUNROLL]"."""
    m = SHAPE_ARG.match(shape)
    if not m:
        raise SystemExit(f"--shape {name}={shape}: expected RUNxTILEH[uN]")
    run, tile_h, unroll = m.group(1), m.group(2), m.group(3) or "1"
    src = (_build.CSRC / "sensor_stencils.cu").read_text()
    entries = ", ".join([f"{{{run}, {tile_h}, {unroll}}}"]
                        * cuda_ops.MAX_COMPILED_HALF)
    out, n = SHAPE_TABLE.subn(lambda m: f"{m.group(1)} {entries}{m.group(3)}",
                              src)
    if n != 1:
        raise SystemExit("csrc/sensor_stencils.cu: no kWindowShapes table")
    d = VARIANT_DIR / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    (d / "sensor_stencils.cu").write_text(out)
    return d


def _spread(runs):
    """{kernel: {version: device ms of each run, mean, spread}}."""
    table = {}
    for r in runs:
        if "device_ms" not in r:
            continue
        v = table.setdefault(r["kernel"], {}).setdefault(
            r["version"], {"device_ms": []})
        v["device_ms"].append(r["device_ms"])
    for versions in table.values():
        for v in versions.values():
            v["mean"] = statistics.mean(v["device_ms"])
            v["spread"] = max(v["device_ms"]) - min(v["device_ms"])
    return table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", default=[],
                    help="NAME=DIR of another version of the kernel sources")
    ap.add_argument("--shape", action="append", default=[],
                    help="NAME=RUNxTILEH[uUNROLL]: the checkout's source "
                         "with every compiled radius at that (kRun, kTileH, "
                         "kRowUnroll)")
    ap.add_argument("--window-sizes", default="3,5,9,11",
                    help="bilateral_window's window sizes, comma-separated")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--runs", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    versions = [(s.split("=", 1)[0], Path(s.split("=", 1)[1]))
                for s in args.csrc]
    for s in args.shape:
        name, shape = s.split("=", 1)
        versions.append((name, shape_variant(name, shape)))
    versions.append(("current", _build.CSRC))
    with ThreadPoolExecutor(len(versions)) as pool:
        paths = list(pool.map(_build.build, [c for _, c in versions]))
    libs = {name: path for (name, _), path in zip(versions, paths)}

    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (args.height, args.width)
    d = torch.randint(400, 6000, shape, generator=gen, device="cuda",
                      dtype=torch.int32)
    d = torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.1,
                    0, d).contiguous()
    fns = kernels([int(k) for k in args.window_sizes.split(",") if k])
    plain = {k: plain_fn(d) for k, (_, plain_fn) in fns.items()}
    order = [name for name, _ in versions]
    order += order[::-1]
    results = []
    print(f"[compare] {smi} | {shape} int32 | device-only time: mean of "
          f"{args.runs} calls replayed from a CUDA graph; per call: median "
          f"of {args.runs} CUDA-event pairs")
    for turn, name in enumerate(order):
        _build.load(libs[name])
        for kernel, (fn, _) in fns.items():
            try:
                outs = fn(d)
            except AttributeError as e:   # the source lacks this launcher
                results.append({"turn": turn, "version": name,
                                "kernel": kernel, "error": str(e)})
                print(f"[compare] turn {turn} {name:10s} {kernel:9s} "
                      f"no launcher: {e}")
                continue
            torch.cuda.synchronize()
            if not all(torch.equal(o, r) for o, r in zip(outs, plain[kernel])):
                raise SystemExit(f"{name} {kernel}: differs from the plain "
                                 f"version")
            dev = device_ms(lambda: fn(d), runs=args.runs)
            call = median_ms(lambda: fn(d), runs=args.runs)
            results.append({"turn": turn, "version": name, "kernel": kernel,
                            "device_ms": dev, "call_ms": call})
            print(f"[compare] turn {turn} {name:10s} {kernel:9s} device "
                  f"{dev:.5f} ms | per call {call:.5f} ms")
    print(json.dumps({"card": smi, "shape": shape, "runs": results,
                      "device_ms_by_kernel": _spread(results)}))


if __name__ == "__main__":
    main()
