"""Kernel probe: does a kernel build and run on this card, and does the
table compositor K3 run at a bench-like tile population? (Counterpart of
the JAX package's dev probe pallas_probe.py.)

    python -m gaussiangrasper_torch.probes.kernel_probe [--device cpu] [--seed 0]

Stages, each announced, each gated on the one before:
  1. the affine kernel (P1) on an (8, 128) float32 array, against 2 x + 1;
  2. `composite_tiles` (K3) on tiny shapes: 4 tiles of 8x8 px, 128 slots
     (64 walked), C 7;
  3. `composite_tiles` at 256 tiles of 16x16 px, 1024 slots (512 walked),
     C 39: the first call (with the kernel's build, if it is not built yet)
     and the steady state, each timed.
On the card, stages 2 and 3 are held against K3's plain version (max abs
error 1e-4). The inputs come from a numpy generator seeded with --seed.
Runs on the card unless --device cpu is given (then the plain versions
run). Exits 1 at the first MISMATCH, 0 when every stage is OK.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from gaussiangrasper_torch._device import resolve_device
from gaussiangrasper_torch.ops import rasterize_cuda as rc
from gaussiangrasper_torch.probes.kernels import affine

ERR_MAX = 1e-4  # K3 against its plain version, the criterion of K1's


def announce(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def tiny_tile_inputs(t=4, k=128, ts=8, c=7, seed=0, device="cpu"):
    """The JAX probe's per-tile arrays, drawn with numpy: k // 2 walked
    slots a tile, centres in the first tile, isotropic conics, opacities
    below 0.5."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    arrays = (
        np.full(t, k // 2, np.int32),
        (rng.uniform(size=(t, k, 2)) * ts).astype(f32),
        np.tile(np.array([0.5, 0.0, 0.5], f32), (t, k, 1)),
        (rng.uniform(size=(t, k)) * 0.5).astype(f32),
        rng.uniform(size=(t, k, c)).astype(f32),
        np.zeros(c, f32),
    )
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _composite_ok(inputs, out, alpha, tw: int, ts: int, device) -> bool:
    """Finite outputs and, on the card, agreement with K3's plain version."""
    ok = bool(torch.isfinite(out).all()) and bool(torch.isfinite(alpha).all())
    if device.type == "cuda":
        counts, xy, con, opac, col, bg = inputs
        tables = torch.cat([xy, con, opac[..., None], col], -1).contiguous()
        want = rc.composite_tables_fwd_plain(counts, tables, bg, tw, ts)
        err = max(float((out - want[0]).abs().max()), float((alpha - want[1]).abs().max()))
        announce(f"  max abs error against the plain version {err:.3g}")
        ok = ok and err <= ERR_MAX
    return ok


def stage1(device) -> bool:
    announce("stage1: launching the affine kernel (P1) ...")
    x = torch.arange(8 * 128, dtype=torch.float32, device=device).reshape(8, 128)
    out = affine(x)
    _sync(device)
    ok = bool(torch.equal(out, x * 2 + 1))
    announce(f"stage1 {'OK' if ok else 'MISMATCH'} (correct={ok})")
    return ok


def stage2(device, seed: int) -> bool:
    announce("stage2: composite_tiles (tiny) ...")
    inputs = tiny_tile_inputs(seed=seed, device=device)
    out, alpha = rc.composite_tiles(*inputs, tw=2, ts=8)
    _sync(device)
    ok = tuple(out.shape) == (4, 64, 7) and _composite_ok(inputs, out, alpha, 2, 8, device)
    announce(f"stage2 {'OK' if ok else 'MISMATCH'} out={tuple(out.shape)} "
             f"alpha_max={float(alpha.max()):.3f}")
    return ok


def stage3(device, seed: int) -> bool:
    announce("stage3: composite_tiles at bench-like population ...")
    inputs = tiny_tile_inputs(t=256, k=1024, ts=16, c=39, seed=seed, device=device)
    t0 = time.perf_counter()
    out, alpha = rc.composite_tiles(*inputs, tw=16, ts=16)
    _sync(device)
    announce(f"stage3 first-call (build+run) {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    out, alpha = rc.composite_tiles(*inputs, tw=16, ts=16)
    _sync(device)
    announce(f"stage3 steady-state {time.perf_counter() - t0:.3f}s for 256 tiles x 1024")
    ok = tuple(out.shape) == (256, 256, 39) and _composite_ok(inputs, out, alpha, 16, 16, device)
    announce(f"stage3 {'OK' if ok else 'MISMATCH'}")
    return ok


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    announce(f"device={device} ({name})")
    if not (stage1(device) and stage2(device, args.seed) and stage3(device, args.seed)):
        return 1
    announce(f"ALL STAGES OK: kernels build and run on {name}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
