"""Per-tile front-to-back compositing over the sorted pair stream
(counterpart of the JAX package's ops/rasterize_pallas.py, K1 only).

`composite_pairs_fwd` launches the hand-written Hopper kernel
`csrc/composite_pairs_fwd.cu` for CUDA tensors and its plain PyTorch
version, `composite_pairs_fwd_plain`, for CPU tensors; for a CUDA tensor
it launches the kernel or raises, never falling back. Every launch adds one
to `composite_pairs_fwd.launches`.

`composite_pair_stream` is the differentiable entry the rasterizer calls.
Its backward is the K2 kernel (`_bwd_pairs_kernel`), which the training
slice ports; until then it raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gaussiangrasper_torch.ops.rasterize import ALPHA_CLAMP, ALPHA_CUTOFF, _LOG_EPS

WALK_CHUNK = 128
"""K1 walks 128-row chunks and counts the zero-alpha rows past `count` in
its last chunk as composited, so an uncut pixel's ncomp is the walk length
rounded up to this. The port reproduces that count exactly."""

KERNEL_CHANNELS = (3, 39)
"""Channel counts the kernel is instantiated for (rgb; rgb + 32-d feature
+ depth + normal). Any other C raises on a CUDA tensor."""


def _pixel_coords(num_tiles: int, tw: int, ts: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, P) integer pixel-centre coordinates of every tile's pixels."""
    t = torch.arange(num_tiles, device=device)[:, None]
    lin = torch.arange(ts * ts, device=device)[None, :]
    px = ((t % tw) * ts + lin % ts).to(torch.float32)
    py = ((t // tw) * ts + lin // ts).to(torch.float32)
    return px, py


def composite_pairs_fwd_plain(pair_gidx, starts, counts, attrs, bg, tw: int, ts: int,
                              count_live: bool = False):
    """Plain PyTorch version of the kernel, one walk step per stream row,
    vectorized over every tile and pixel, in the kernel's operation order.

    pair_gidx (B,) int32; starts, counts (T,) int32 with counts <= B - starts;
    attrs (N, 6 + C) rows xy | conic (a, b, c) | opacity | colour; bg (C,).
    Returns out (T, P, C), alpha, logt, ncomp (T, P) float32, plus, with
    `count_live`, the per-pixel number of composited entries with nonzero
    alpha (the walk's work, for the roofline bound)."""
    T = starts.shape[0]
    C = attrs.shape[1] - 6
    dev = attrs.device
    px, py = _pixel_coords(T, tw, ts, dev)
    acc = torch.zeros(T, ts * ts, C, dtype=torch.float32, device=dev)
    cum_all = torch.zeros(T, ts * ts, dtype=torch.float32, device=dev)
    logt = torch.zeros_like(cum_all)
    cut = torch.full(cum_all.shape, -1, dtype=torch.int64, device=dev)
    live = torch.zeros(cum_all.shape, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    counts64 = counts.to(torch.int64)
    kmax = int(counts64.max()) if T else 0
    for k in range(kmax):
        walking = (counts64 > k)[:, None] & (cut < 0)
        pos = torch.where(counts64 > k, starts.to(torch.int64) + k, 0)
        row = attrs[pair_gidx[pos].to(torch.int64)]  # (T, 6 + C)
        dx = px - row[:, 0:1]
        dy = py - row[:, 1:2]
        sigma = 0.5 * (row[:, 2:3] * dx * dx + row[:, 4:5] * dy * dy) + row[:, 3:4] * dx * dy
        a = torch.clamp(row[:, 5:6] * torch.exp(-sigma), max=ALPHA_CLAMP)
        ok = walking & (sigma >= 0.0) & (a >= ALPHA_CUTOFF)
        lt = torch.log1p(-a)
        cum = cum_all + lt
        crossed = ok & ~(cum > _LOG_EPS)
        comp = ok & ~crossed
        w = torch.where(comp, a * torch.exp(logt), zero)
        acc = acc + w[..., None] * row[:, None, 6:]
        logt = torch.where(comp, logt + lt, logt)
        cum_all = torch.where(comp, cum, cum_all)
        cut = torch.where(crossed, k, cut)
        live = live + comp.to(torch.int64)
    t_final = torch.exp(logt)
    out = acc + t_final[..., None] * bg
    walk_len = (counts64 + WALK_CHUNK - 1) // WALK_CHUNK * WALK_CHUNK
    ncomp = torch.where(cut >= 0, cut, walk_len[:, None]).to(torch.float32)
    res = (out, 1.0 - t_final, logt, ncomp)
    return res + (live,) if count_live else res


def _check_inputs(pair_gidx, starts, counts, attrs, bg):
    dev = attrs.device
    for name, x, dt in (("pair_gidx", pair_gidx, torch.int32), ("starts", starts, torch.int32),
                        ("counts", counts, torch.int32), ("attrs", attrs, torch.float32),
                        ("bg", bg, torch.float32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, attrs on {dev}")
        if x.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if attrs.ndim != 2 or bg.shape != (attrs.shape[1] - 6,):
        raise ValueError(f"attrs {tuple(attrs.shape)} / bg {tuple(bg.shape)}: want (N, 6+C) / (C,)")
    if starts.shape != counts.shape or starts.ndim != 1:
        raise ValueError("starts and counts must be (T,)")
    if starts.numel():
        # the kernel reads pair_gidx[starts, starts + counts) and attrs[pair_gidx]
        # without bounds checks: one reduction (one sync) rejects what would not fit
        b, n = pair_gidx.shape[0], attrs.shape[0]
        bad = (starts < 0).any() | (counts < 0).any() | ((starts.long() + counts) > b).any()
        if pair_gidx.numel():
            bad = bad | (pair_gidx.min() < 0) | (pair_gidx.max() >= n)
        if bool(bad):
            raise ValueError(f"segments must lie in pair_gidx ({b} rows) and pair_gidx "
                             f"must index attrs ({n} rows)")


def _launch_kernel(pair_gidx, starts, counts, attrs, bg, tw: int, ts: int):
    C = attrs.shape[1] - 6
    if C not in KERNEL_CHANNELS:
        raise ValueError(f"composite_pairs_fwd kernel is built for C in {KERNEL_CHANNELS}, got {C}")
    if ts * ts > 1024:
        raise ValueError(f"tile_size {ts}: one thread per pixel needs ts*ts <= 1024")
    from gaussiangrasper_torch._build import load_library

    lib = load_library("composite_pairs_fwd")
    fn = lib.ggt_composite_pairs_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
    lib.ggt_cuda_error_string.restype = ctypes.c_char_p
    lib.ggt_cuda_error_string.argtypes = [ctypes.c_int]

    T = starts.shape[0]
    P = ts * ts
    out = torch.empty(T, P, C, dtype=torch.float32, device=attrs.device)
    alpha, logt, ncomp = (torch.empty(T, P, dtype=torch.float32, device=attrs.device)
                          for _ in range(3))
    if T == 0:
        return out, alpha, logt, ncomp
    stream = torch.cuda.current_stream(attrs.device).cuda_stream
    err = fn(pair_gidx.data_ptr(), starts.data_ptr(), counts.data_ptr(), attrs.data_ptr(),
             bg.data_ptr(), T, tw, ts, C, out.data_ptr(), alpha.data_ptr(), logt.data_ptr(),
             ncomp.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("composite_pairs_fwd launch failed: "
                           + lib.ggt_cuda_error_string(err).decode())
    composite_pairs_fwd.launches += 1
    return out, alpha, logt, ncomp


def composite_pairs_fwd(pair_gidx, starts, counts, attrs, bg, tw: int, ts: int):
    """K1's four outputs (out (T, P, C), alpha, logt, ncomp (T, P)): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Arguments as in `composite_pairs_fwd_plain`."""
    _check_inputs(pair_gidx, starts, counts, attrs, bg)
    if attrs.device.type == "cuda":
        return _launch_kernel(pair_gidx, starts, counts, attrs, bg, tw, ts)
    if attrs.device.type != "cpu":
        raise ValueError(f"composite_pairs_fwd runs on cuda or cpu, not {attrs.device}")
    return composite_pairs_fwd_plain(pair_gidx, starts, counts, attrs, bg, tw, ts)


composite_pairs_fwd.launches = 0


def pack_attrs(xys, conics, opacities, colors) -> torch.Tensor:
    """Per-Gaussian attribute rows (N, 6 + C): xy | conic | opacity | colour."""
    return torch.cat([xys, conics, opacities[:, None], colors], dim=1).float().contiguous()


def stream_bounds(pair_gidx, seg_starts, tile_count, k_cap: int):
    """Per-tile walk (starts, counts), int32: min(tile_count, k_cap,
    B - start) pairs from min(start, B), the JAX entry's clamp."""
    b = pair_gidx.shape[0]
    starts = torch.clamp(seg_starts, max=b)
    counts = torch.minimum(torch.clamp(tile_count, max=k_cap), torch.clamp(b - starts, min=0))
    return starts.to(torch.int32).contiguous(), counts.to(torch.int32).contiguous()


class _CompositePairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pair_gidx, starts, counts, xys, conics, opacities, colors, bg, tw, ts):
        out, alpha, _, _ = composite_pairs_fwd(pair_gidx, starts, counts,
                                               pack_attrs(xys, conics, opacities, colors),
                                               bg.float().contiguous(), tw, ts)
        return out, alpha

    @staticmethod
    def backward(ctx, g_out, g_alpha):
        raise NotImplementedError("K2 _bwd_pairs_kernel: next slice")


def composite_pair_stream(pair_gidx, seg_starts, tile_count, xys, conics, opacities, colors,
                          bg, tw: int, ts: int, k_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile compositing straight off the sorted pair stream; walks
    `stream_bounds` pairs per tile. Returns (out (T, P, C), alpha (T, P))."""
    starts, counts = stream_bounds(pair_gidx, seg_starts, tile_count, k_cap)
    return _CompositePairs.apply(pair_gidx.to(torch.int32).contiguous(), starts, counts,
                                 xys, conics, opacities, colors, bg, tw, ts)
