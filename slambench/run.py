"""Run one cell of the port's benchmark and print its result line.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, slambench/ and the
program (octree_slam_tpu_torch/). The last line of standard output is one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device (and with --trace 1
breakdown), and last `checks`, each number that decided `correct` beside
its limit, which also end standard error. A run without a CUDA device, or
with fewer than the cell asks for, exits 2 and prints no result; a run
that finds JAX or the JAX package loaded once its window has closed exits
3 and prints no result.
"""

import time

T_NOW = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# kernel caches at fixed paths inside the checkout: only a checkout's
# first run builds (the program's nvcc library lands in its own
# octree_slam_tpu_torch/_kernels_build/)
CACHE = ROOT / ".slambench_cache"


def process_start() -> float:
    """The perf_counter time at which this process started (Linux), or
    the time this module began where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return T_NOW - max(age, 0.0) if age < 600 else T_NOW
    except (OSError, ValueError, IndexError):
        return T_NOW


def main(argv=None) -> int:
    t0 = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one process with few threads: the host side of the loop is one
    # thread issuing launches
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    import torch
    from slambench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    import octree_slam_tpu_torch
    pkg = Path(octree_slam_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        print(f"the program must come from this checkout, found {pkg}",
              file=sys.stderr)
        return 2

    cell = harness.load_cell(args.workload, ROOT)
    result = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), device="cuda",
        t_start=t0, log=lambda msg: print(msg, file=sys.stderr))
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded after the window, forbidden: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
