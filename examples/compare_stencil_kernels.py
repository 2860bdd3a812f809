"""Time versions of the sensor-stencil source in turns on one card.

    mkdir -p build/base
    git show <commit>:octree_slam_tpu_torch/csrc/sensor_stencils.cu \\
        > build/base/sensor_stencils.cu
    PYTHONPATH=. python examples/compare_stencil_kernels.py --csrc base=build/base

Each `--csrc NAME=DIR` names a directory of kernel sources with the
package's C interface (`_build.load` declares it); the checkout's own
`csrc/` always comes after them as "current". Each version is built by
`_build.build` and loaded in turn by `_build.load`, and timed through the
package's own wrappers (`cuda_ops.bilateral`, `cuda_ops.gated_pyramid` with
both levels). The versions run in the order given and then back (A, B, B,
A), so a drift of clock or power over the call shows up as a difference
between the two runs of one version. Every version must give the same
pixels as the plain versions. Prints one line per run and a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from octree_slam_tpu_torch import _build
from octree_slam_tpu_torch.sensor import cuda_ops
from octree_slam_tpu_torch.utils.timing import device_ms, median_ms

SIGMA_SPATIAL, SIGMA_DEPTH, GATE = 4.5, 40.0, 120.0


def kernels():
    """name -> (kernel, plain): callables of a depth tensor returning a
    list of outputs."""
    return {
        "bilateral": (
            lambda d: [cuda_ops.bilateral(d, SIGMA_SPATIAL, SIGMA_DEPTH)],
            lambda d: [cuda_ops.bilateral_plain(d, SIGMA_SPATIAL,
                                                SIGMA_DEPTH)]),
        "gated": (lambda d: cuda_ops.gated_pyramid(d, GATE, 2),
                  lambda d: cuda_ops.gated_pyramid_plain(d, GATE, 2)),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", action="append", default=[],
                    help="NAME=DIR of another version of the kernel sources")
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
                for s in args.csrc] + [("current", _build.CSRC)]
    libs = {name: _build.build(csrc) for name, csrc in versions}

    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (args.height, args.width)
    d = torch.randint(400, 6000, shape, generator=gen, device="cuda",
                      dtype=torch.int32)
    d = torch.where(torch.rand(shape, generator=gen, device="cuda") < 0.1,
                    0, d).contiguous()
    fns = kernels()
    plain = {k: plain_fn(d) for k, (_, plain_fn) in fns.items()}
    order = [name for name, _ in versions]
    order += order[::-1]
    results = []
    print(f"[compare] {smi} | {shape} int32 | device-only time: mean of "
          f"{args.runs} launches under torch.profiler; per call: median of "
          f"{args.runs} CUDA-event pairs")
    for turn, name in enumerate(order):
        _build.load(libs[name])
        for kernel, (fn, _) in fns.items():
            outs = fn(d)
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
    print(json.dumps({"card": smi, "shape": shape, "runs": results}))


if __name__ == "__main__":
    main()
