#!/usr/bin/env python3
"""The control readings of a cell: the plain reference in TF32 put in the
program's place, compared as a run compares the program, at the cell's own
sizes, on each seed given; with ``--faults`` also the reference in f32 with
each fault the cell's driver lists planted in it.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--faults]

Prints one line per seed and reading with each compared number and its
limit; the control, and each fault, has to fail at least one limit. The
benchmark's runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    from portbench.harness import env

    env.fix_caches()
    from portbench.harness import cell, registry

    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = cell.context(args.workload, seed, 0.0, False, args.device,
                           time.perf_counter())
        cell.precision(ctx)
        driver = registry.driver(ctx.traffic["driver"])
        for fault in ("",) + (driver.FAULTS if args.faults else ()):
            checks = driver.control(ctx, fault)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": fault or "tf32",
                              "checks": {c.name: {"value": c.value,
                                                  "limit": c.limit,
                                                  "fails": not c.ok}
                                         for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
