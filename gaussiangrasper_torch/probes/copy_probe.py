"""Copy probe: row blocks read and written at dynamic, unaligned offsets.
(Counterpart of the JAX package's dev probe dma_probe.py.)

    python -m gaussiangrasper_torch.probes.copy_probe [--device cpu]

Stages:
  1. 128-row reads (P2) from a (4096, 128) float32 array at aligned row
     offsets [0, 8, 256];
  2. the same at unaligned offsets [3, 77, 1001];
  3. overlapping 128-row writes (P3) at [0, 100, 200] into 512 rows, block
     t filled with t + 1: the later block must win where they overlap.
Reads must equal the source rows exactly; writes are checked on the rows
some block covers. Runs on the card unless --device cpu is given (then the
plain versions run). Exits 1 if any stage prints MISMATCH.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from gaussiangrasper_torch._device import resolve_device
from gaussiangrasper_torch.probes.kernels import BLOCK_ROWS, COLS, read_at, write_at

ROWS = 4096
READ_OFFSETS = (("aligned", (0, 8, 256)), ("UNALIGNED", (3, 77, 1001)))
WRITE_OFFSETS, WRITE_ROWS = (0, 100, 200), 512


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    x = torch.arange(ROWS * COLS, dtype=torch.float32, device=device).reshape(ROWS, COLS)
    all_ok = True

    for label, offs in READ_OFFSETS:
        starts = torch.tensor(offs, dtype=torch.int32, device=device)
        out = read_at(x, starts)
        ref = torch.stack([x[o: o + BLOCK_ROWS] for o in offs])
        ok = bool(torch.equal(out, ref))
        all_ok &= ok
        print(f"read {label}: {'OK' if ok else 'MISMATCH'}", flush=True)

    # overlapping unaligned writes, ascending starts: the later block must win
    starts = torch.tensor(WRITE_OFFSETS, dtype=torch.int32, device=device)
    vals = torch.stack([torch.full((BLOCK_ROWS, COLS), float(i + 1), device=device)
                        for i in range(len(WRITE_OFFSETS))])
    a = write_at(vals, starts, WRITE_ROWS).cpu()
    ok = bool((a[:100] == 1).all() and (a[100:200] == 2).all() and (a[200:328] == 3).all())
    all_ok &= ok
    print(f"write UNALIGNED overlap (later wins): {'OK' if ok else 'MISMATCH'}", flush=True)
    return 0 if all_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
