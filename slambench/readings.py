"""The readings that set each limit of `correct`: one process runs a cell
on many seeds and prints, for each, the program's numbers and those of
the control (the reference computed in TF32 in the program's place), or
with --faults the program's numbers with each named fault of
slambench/faults.py planted under the timed path.

    python3 slambench/readings.py --workload <cell> --seeds 1,2,3 \
        --seconds 51 [--faults half_frame,moved_pose] [--out readings.jsonl]

The benchmark's own runs never run the control. Needs a CUDA device.
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
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from slambench import faults, harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
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
                                 fault))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


def _reading(harness, faults, cell, seed, seconds, fault):
    log = lambda m: print(m, file=sys.stderr)  # noqa: E731
    if fault is None:
        out = harness.run_cell(cell, seed, seconds, False, control=True,
                               log=log)
    else:
        with faults.planted(fault):
            out = harness.run_cell(cell, seed, seconds, False, log=log)
    row = {"workload": cell.name, "seed": seed, "fault": fault,
           "attempted": out["attempted"], "correct": out["correct"],
           "program": {k: c["value"] for k, c in out["checks"].items()},
           "control": out.get("control"),
           "metrics": {k: m["value"] for k, m in out["metrics"].items()}}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    sys.exit(main())
