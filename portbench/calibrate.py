"""Read what the limits of a cell are set from, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \\
        --control-seeds 3 --seconds 3 [--first-seed N]

For each of ``--seeds`` seeds a run of the cell with a short window (the
cell's own sizes and load) gives the numbers the comparison reads: the
largest over the seeds is each number's lower reading.  For each of
``--control-seeds`` seeds the control (the reference in bfloat16 in the
program's place) gives its readings, and a fit's faults theirs: the
smallest control reading is each number's upper one.  Prints a JSON line
a reading and a last line with both readings of every number.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import core  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_017)
    a = p.parse_args(argv)
    core.use_checkout_caches()
    import torch
    from portbench import run
    cell = core.find_cell(a.workload)
    lower, upper, dev = {}, {}, torch.device("cuda")
    for k in range(a.seeds):
        seed = a.first_seed + 7919 * k
        args = argparse.Namespace(workload=a.workload, seed=seed,
                                  seconds=a.seconds, trace=0)
        line, _ = run.execute(args, core.find_cell(a.workload), "cuda")
        got = {n: c["value"] for n, c in line["checks"].items()}
        for n, v in got.items():
            lower[n] = max(lower.get(n, 0.0), v if v is not None
                           else float("inf"))
        print(json.dumps({"program": seed, "checks": got,
                          "correct": line["correct"],
                          "metrics": line["metrics"]}), flush=True)
    drv = core.driver(cell.traffic)
    for k in range(a.control_seeds):
        seed = a.first_seed + 104729 * (k + 1)
        t = time.perf_counter()
        got = drv.control(cell, seed, dev)
        for n, v in got.items():
            if v == v:              # a control that gives NaN sets none
                upper[n] = min(upper.get(n, float("inf")), v)
        print(json.dumps({"control": seed, "checks": got,
                          "seconds": time.perf_counter() - t}), flush=True)
        if hasattr(drv, "faults"):
            print(json.dumps({"faults": seed,
                              "checks": drv.faults(cell, seed, dev)}),
                  flush=True)
    print(json.dumps({"workload": a.workload, "lower": lower,
                      "upper": upper, "card": core.card_line()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
