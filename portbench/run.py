#!/usr/bin/env python3
"""The benchmark of gaussiangrasper_torch, the PyTorch and CUDA port, on
NVIDIA cards. From the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It finds the cell in BENCHMARK.json, its configuration under configs/,
its traffic under traffic/ (which names the driver under drivers/) and
its limits under limits/; sets up, measures for `--seconds`, checks what
the timed path produced against the plain reference under reference/,
and prints one JSON line last on stdout: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), device, with --trace 1 breakdown, and the checks last. It
exits non-zero with no result where the cards are missing or too few, or
where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(BENCH / "cache" / sub)
sys.path[:0] = [str(BENCH), str(ROOT)]


def main(argv=None) -> int:
    from harness import common

    t_proc = common.process_start()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = common.cell(args.workload)
    common.require_devices(cell["chips"])
    print(f"portbench card: {common.power_limit()}", file=sys.stderr)
    drv = common.driver(cell["traffic_data"]["driver"])
    result, checks = common.run_cell(drv, cell, args.seed, args.seconds, bool(args.trace), t_proc)
    found = common.jax_modules()
    if found:
        print(f"portbench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    keys = ("correct", "attempted", "failed", "metrics", "device", "breakdown")
    common.emit({k: result[k] for k in keys if k in result}, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
