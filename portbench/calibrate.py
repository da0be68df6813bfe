#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--control-seeds <n> ...] [--seconds <s>] [--out <file.jsonl>]

For each seed: the cell's set-up and a short window at its own load, then
the numbers compared against the plain reference (the program's readings);
for each control seed also the control's readings: the reference in TF32,
the precision below the configuration's, in the program's place.  One JSON
line a seed, to stdout and to `--out`.  The benchmark's own runs never run
the control.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    from portbench.harness.bench import run_cell

    fh = open(args.out, "a") if args.out else None
    try:
        for seed in list(args.seeds) + [s for s in args.control_seeds
                                        if s not in args.seeds]:
            t0 = time.perf_counter()
            drivers = []
            out = run_cell(args.workload, seed, args.seconds, False,
                           control=seed in args.control_seeds,
                           driver_hook=drivers.append)
            line = {"workload": args.workload, "seed": seed,
                    "program": out["_numbers"],
                    "control": out.get("_control"),
                    "rounds": out["attempted"],
                    # the fewest valid spots a fitted channel had in a round
                    "least_spots": [int(min(o["valid"][f].sum()
                                            for _, o in drivers[0].outputs))
                                    for f in range(len(
                                        drivers[0].outputs[0][1]["valid"]))],
                    "seconds": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            if fh:
                fh.write(json.dumps(line) + "\n")
                fh.flush()
            torch.cuda.empty_cache()
    finally:
        if fh:
            fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
