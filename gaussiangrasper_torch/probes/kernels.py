"""The platform probe kernels P1-P3 (`csrc/probes.cu`) and their plain
PyTorch versions.

- `affine` (P1): o = 2 x + 1, the minimal build-and-launch probe.
- `read_at` (P2): block t of the (T, 128, 128) output is rows [starts[t],
  starts[t] + 128) of x (rows, 128), copied by the bulk copy engine at a
  dynamic, unaligned row offset.
- `write_at` (P3): block t of vals (T, 128, 128) goes to rows [starts[t],
  starts[t] + 128) of a (rows, 128) output; where blocks overlap, the later
  block wins. Rows that no block covers are unspecified (the kernel leaves
  them as allocated; the plain version fills them with NaN, as the JAX
  probe reads in interpret mode).

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors (`_device.use_kernel`), and launches through
`_build.launch`, whose counter keys each launch by its C entry
(`ggt_probe_affine`, ...).
"""

from __future__ import annotations

import ctypes

import torch

from gaussiangrasper_torch._build import launch
from gaussiangrasper_torch._device import use_kernel

BLOCK_ROWS = 128
"""Rows per block (the TPU probe's KC)."""
COLS = 128
"""Floats per row (the TPU probe's lane width)."""


def affine_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0 + 1.0


def _launch_affine(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    launch("probes", "ggt_probe_affine", [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
           x.data_ptr(), x.numel(), out.data_ptr(), device=x.device)
    return out


def affine(x: torch.Tensor) -> torch.Tensor:
    """P1: 2 x + 1 for a contiguous float32 tensor."""
    kernel = use_kernel(x.device, "affine")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError("affine takes a non-empty contiguous float32 tensor")
    return _launch_affine(x) if kernel else affine_plain(x)


def _check_blocks(starts: torch.Tensor, rows: int, device) -> None:
    if starts.dtype != torch.int32 or starts.ndim != 1 or not starts.is_contiguous() \
            or starts.numel() == 0 or starts.device != device:
        raise ValueError(f"starts must be a non-empty contiguous (T,) int32 tensor on {device}")
    # the kernels copy rows [s, s + 128) without bounds checks: one sync
    if bool((starts < 0).any() | (starts > rows - BLOCK_ROWS).any()):
        raise ValueError(f"starts must lie in [0, {rows - BLOCK_ROWS}] for {rows} rows")


def read_at_plain(x: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    rows = starts.to(torch.int64)[:, None] + torch.arange(BLOCK_ROWS, device=x.device)
    return x[rows]


def read_at(x: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """P2: (T, 128, 128) blocks of x (rows, 128) float32 at row offsets starts (T,) int32."""
    kernel = use_kernel(x.device, "read_at")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != COLS or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (rows, {COLS}) float32 tensor")
    _check_blocks(starts, x.shape[0], x.device)
    if not kernel:
        return read_at_plain(x, starts)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned for the bulk copy")
    return _launch_read_at(x, starts)


def _launch_read_at(x: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    out = torch.empty(starts.shape[0], BLOCK_ROWS, COLS, dtype=torch.float32, device=x.device)
    launch("probes", "ggt_probe_read_at", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_void_p],
           x.data_ptr(), starts.data_ptr(), starts.shape[0], out.data_ptr(), device=x.device)
    return out


def write_at_plain(vals: torch.Tensor, starts: torch.Tensor, rows: int) -> torch.Tensor:
    """The TPU grid's order replayed: block 0's write first, the last block's last."""
    out = torch.full((rows, COLS), float("nan"), dtype=torch.float32, device=vals.device)
    for t, s in enumerate(starts.tolist()):
        out[s: s + BLOCK_ROWS] = vals[t]
    return out


def write_at(vals: torch.Tensor, starts: torch.Tensor, rows: int) -> torch.Tensor:
    """P3: a (rows, 128) float32 output with block t of vals (T, 128, 128) at
    row offset starts[t], the later block winning where blocks overlap."""
    kernel = use_kernel(vals.device, "write_at")
    if vals.dtype != torch.float32 or vals.shape[1:] != (BLOCK_ROWS, COLS) \
            or not vals.is_contiguous():
        raise ValueError(f"vals must be a contiguous (T, {BLOCK_ROWS}, {COLS}) float32 tensor")
    _check_blocks(starts, rows, vals.device)
    if starts.shape[0] != vals.shape[0]:
        raise ValueError(f"{starts.shape[0]} starts for {vals.shape[0]} blocks")
    return _launch_write_at(vals, starts, rows) if kernel else write_at_plain(vals, starts, rows)


def _launch_write_at(vals: torch.Tensor, starts: torch.Tensor, rows: int) -> torch.Tensor:
    out = torch.empty(rows, COLS, dtype=torch.float32, device=vals.device)
    launch("probes", "ggt_probe_write_at", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p],
           vals.data_ptr(), starts.data_ptr(), starts.shape[0], rows, out.data_ptr(),
           device=vals.device)
    return out


def covered_rows(starts, rows: int) -> torch.Tensor:
    """(rows,) bool: the rows some block covers (the only rows write_at specifies)."""
    mask = torch.zeros(rows, dtype=torch.bool)
    for s in starts.tolist():
        mask[s: s + BLOCK_ROWS] = True
    return mask
