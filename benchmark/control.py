#!/usr/bin/env python3
"""Readings for the limits of the comparison that decides ``correct``,
many seeds in one process (the benchmark's own runs never run this).

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
        [--solves K] [--control]

Without ``--control``: the program's numbers, the lower readings.  With
it: the control's, the program with its own path of the precision below
the configuration's switched on (the configuration file's ``control``
entries), the upper readings.  Each seed runs ``--solves`` whole solves
from that seed's guesses, as a run's window does, and prints one JSON
line; the last line holds, for each number, the largest and the smallest
over the seeds of a seed's largest.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--solves", type=int, default=1)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import core
    import torch
    cell = core.Cell(args.workload, control=args.control)
    cell.warm_up(args.seeds[0])
    per_seed = []
    for seed in args.seeds:
        recs = [cell.solve(seed, i) for i in range(args.solves)]
        for i, r in enumerate(recs):
            core.log(f"seed {seed} " + core.describe(i, r))
        numbers, failed, per = cell.judge(recs)
        row = {"seed": seed, "walls": [r["wall_s"] for r in recs],
               "applies": [r["port_applies"] for r in recs],
               "readings": per, "failed": failed,
               "max": {k: v for k, (v, _) in numbers.items()}}
        per_seed.append(row)
        print(json.dumps(row), flush=True)
    names = per_seed[0]["max"]
    print(json.dumps({
        "workload": args.workload, "control": args.control,
        "device": torch.cuda.get_device_name(0),
        "largest": {k: max(r["max"][k] for r in per_seed) for k in names},
        "smallest": {k: min(r["max"][k] for r in per_seed) for k in names},
        "limits": cell.limits}), flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"control: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
