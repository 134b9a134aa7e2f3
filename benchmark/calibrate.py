"""Readings that the limits of a cell's check are set from (not part of a
benchmark run).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --seconds <s> [--control <precision> --control-seeds 7,8,9]

For each of ``--seeds`` it makes a whole run of the cell in this process
(the program's readings, the lower ones) and prints its line; for each of
``--control-seeds`` it puts the reference at ``--control`` ("tf32" or
"bfloat16") in the program's place over the inputs of a run as long as the
program's mean run, and prints the same numbers (the upper readings). One
JSON line per reading, ending with a summary."""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parents[1]))

from harness import runner  # noqa: E402
from harness.spec import Cell  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--control", default=None)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--actions", type=int, default=0,
                    help="actions per control run (default: the program's "
                         "mean over --seeds)")
    args = ap.parse_args()
    lower, attempted = {}, []
    for s in [int(x) for x in args.seeds.split(",") if x]:
        res = runner.run(args.workload, s, args.seconds, False)
        attempted.append(res["attempted"])
        print(json.dumps({"seed": s, "program": res}), flush=True)
        for k, v in res["check"].items():
            if v["value"] is not None:
                lower[k] = max(lower.get(k, 0.0), v["value"])
    upper = {}
    if args.control:
        cell = Cell(args.workload)
        n = args.actions or (sum(attempted) // max(len(attempted), 1))
        for s in [int(x) for x in args.control_seeds.split(",") if x]:
            drv = cell.driver().Driver(cell, cell.model(), cell.entry(), s,
                                       "cuda")
            nums = drv.control(n, args.control, cell.limits)
            print(json.dumps({"seed": s, "control": args.control,
                              "actions": n, "check": nums}), flush=True)
            for k, v in nums.items():
                if v["value"] is not None:
                    upper[k] = min(upper.get(k, float("inf")), v["value"])
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
