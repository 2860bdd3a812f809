"""The readings that set each limit of `correct`: one process runs a cell
on many seeds and prints, for each, the program's numbers and those of
the control (the reference computed in TF32 in the program's place), or
with --faults the program's numbers with each named fault of
slambench/faults.py planted under the timed path.

    python3 slambench/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 51 [--faults half_frame,moved_pose] [--out readings.jsonl] \
        [--traffic '{"kind": "dropout", "blank_every": 30, "blank_frames": 3}']

--traffic merges a JSON object into the cell's traffic mix: a mix that no
cell of BENCHMARK.json runs yet, on that cell's configuration and limits.
--frames closes each window after that many frames (or its seconds,
whichever comes first); --no-control runs the program alone. The
benchmark's own runs never run the control. Needs a CUDA device.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", default="",
                    help="comma-separated names of slambench/faults.py")
    ap.add_argument("--out", default=None)
    ap.add_argument("--traffic", default=None,
                    help="a JSON object merged into the cell's traffic mix")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from slambench import faults, harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    if args.traffic:
        cell.traffic = dict(cell.traffic, **json.loads(args.traffic))
    names = [f for f in args.faults.split(",") if f]
    unknown = set(names) - set(faults.FAULTS)
    if unknown:
        print(f"no fault {sorted(unknown)} in slambench/faults.py",
              file=sys.stderr)
        return 2
    rows = []
    for fault in names or [None]:
        for seed in (int(s) for s in args.seeds.split(",")):
            rows.append(_reading(harness, faults, cell, seed, args.seconds,
                                 fault, args.frames, not args.no_control))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


def _reading(harness, faults, cell, seed, seconds, fault, frames, control):
    log = lambda m: print(m, file=sys.stderr)  # noqa: E731
    if fault is None:
        out = harness.run_cell(cell, seed, seconds, False, control=control,
                               max_frames=frames, log=log)
    else:
        with faults.planted(fault):
            out = harness.run_cell(cell, seed, seconds, False,
                                   max_frames=frames, log=log)
    row = {"workload": cell.name, "seed": seed, "fault": fault,
           "traffic": cell.traffic.get("kind", "orbit"),
           "attempted": out["attempted"], "failed": out["failed"],
           "correct": out["correct"], "recovery": out["recovery"],
           "program": {k: c["value"] for k, c in out["checks"].items()},
           "control": out.get("control"),
           "metrics": {k: m["value"] for k, m in out["metrics"].items()}}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    sys.exit(main())
