"""Read a cell's compared numbers over many seeds in one process, to set
the limits of its comparison (``benchmark/workloads/<cell>.json``):

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,13 --seconds 2 [--control]

Each seed runs the cell's set-up, a short window and the comparison, as
``run.py`` does; ``--control`` puts the reference at the control
precision in the program's place (its runs must come out not correct).
Prints one JSON line per seed, with ``correct`` as the cell's limits judge
it, and the largest reading of each number last.  Not a benchmark run: it prints no
metrics.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from benchmark import harness  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    cell = harness.load_cell(ROOT, args.workload)
    worst = {}
    for seed in (int(x) for x in args.seeds.split(",")):
        res = harness.execute(cell, seed, args.seconds, False, "cuda", time.time(),
                              control=args.control)
        vals = {name: c["value"] for name, c in res["checks"].items()}
        for name, v in vals.items():
            worst[name] = max(worst.get(name, 0.0), v)
        print(json.dumps({"seed": seed, "control": args.control, "attempted": res["attempted"],
                          "correct": res["correct"], "checks": vals}), flush=True)
    print(json.dumps({"workload": cell.name, "control": args.control, "max": worst}), flush=True)
    return 0


if __name__ == "__main__":
    harness.configure_env(ROOT)
    sys.exit(main(sys.argv[1:]))
