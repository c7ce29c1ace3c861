#!/usr/bin/env python3
"""Readings for the limits of a cell's correctness check, on the card, in
one process:

    python3 portbench/calibrate.py --workload <cell> --seeds <n> ... \\
        [--control-seeds <n> ...] [--fault-seeds <n> ...] [--seconds <s>] [--out <file>]

For each seed it sets the cell up as a run does, drives the program
through the steps the check follows (a training cell's warm-up; a serving
cell's requests for `--seconds`) and prints the numbers the check compares,
one JSON line a reading:
- "sound": the program against the plain reference (the lower readings);
- "control": the reference in TF32, the precision below the
  configuration's float32, in the program's place (the upper readings);
- each fault the driver can plant (`FAULTS`), planted in the program
  (a state left unchanged reads 1 on the parameters' change by its
  measure; it is read for the numbers it also moves).
Limits are then set from these readings (PERF.md gives them).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def readings(cell: dict, drv, seed: int, fault, control: bool, seconds: float,
             device: str = "cuda") -> dict:
    r = drv.Run(cell, seed, fault=fault, device=device)
    r.setup()
    if hasattr(r, "warmup"):
        r.warmup()
    else:
        r.window(seconds)
    r.free_program()
    chk = drv.Check(r)
    out = {"sound" if fault is None else fault: chk.numbers()}
    if control:
        out["control"] = chk.numbers(control=True)
    return out


def main(argv=None) -> int:
    from harness import common

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=None,
                   help="the faults to plant on --fault-seeds (default: every one the driver has)")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    cell = common.cell(args.workload)
    common.require_devices(cell["chips"])
    drv = common.driver(cell["traffic_data"]["driver"])
    jobs = [(s, None, s in args.control_seeds) for s in args.seeds]
    faults = drv.FAULTS if args.faults is None else args.faults
    jobs += [(s, f, False) for s in args.fault_seeds for f in faults]
    for seed, fault, control in jobs:
        t0 = time.perf_counter()
        for kind, numbers in readings(cell, drv, seed, fault, control, args.seconds).items():
            line = json.dumps({"cell": args.workload, "seed": seed, "kind": kind, "numbers": numbers,
                               "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if args.out is not None:
                args.out.parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a") as fh:
                    fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
