"""Per-tile compositing over the sorted pair stream, forward and backward
(counterpart of the JAX package's ops/rasterize_pallas.py, pair-stream
kernels K1 and K2).

`composite_pairs_fwd` (K1, `csrc/composite_pairs_fwd.cu`) and
`composite_pairs_bwd` (K2, `csrc/composite_pairs_bwd.cu`) launch their
hand-written Hopper kernels for CUDA tensors and their plain PyTorch
versions (`composite_pairs_fwd_plain`, `composite_pairs_bwd_plain`) for CPU
tensors; for a CUDA tensor they launch the kernel or raise, never falling
back. Every launch adds one to the wrapper's `launches`.

`composite_pair_stream` is the differentiable entry the rasterizer calls:
K1 forward, K2 backward, then one `index_add_` by the pair payload into
per-Gaussian gradients and the background gradient sum_p T_final g_out.

Gradient identities (out = sum_k w_k c_k + T_final bg, w_k = alpha_k
prod_{j<k} (1 - alpha_j), the cut folded into alpha):
  dL/dc_k      = sum_p w_kp g_out[p]
  dL/dalpha_kp = T_before <c_k, g> - suffix_k / (1 - alpha)
                 - (<bg, g_out[p]> - g_alpha_p) T_final / (1 - alpha)
with suffix_k = sum_{j>k} w_j <c_j, g>; then through alpha = min(.999,
o exp(-sigma)): do = exp(-sigma) dalpha, dsigma = -o exp(-sigma) dalpha
(0 where clamped or invalid), sigma = .5 (a dx^2 + c dy^2) + b dx dy with
dx = px - x_k: da = .5 dx^2 dsigma, db = dx dy dsigma, dc = .5 dy^2 dsigma,
dx_k = -(a dx + b dy) dsigma, dy_k = -(b dx + c dy) dsigma.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from gaussiangrasper_torch._device import full_f32
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


def composite_pairs_bwd_plain(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp,
                              tw: int, ts: int):
    """Plain PyTorch version of K2: the reverse walk, one stream row at a
    time from the last composited row down to 0, vectorized over every
    tile and pixel, in the kernel's operation order.

    Stream inputs as in `composite_pairs_fwd_plain`; g_out (T, P, C),
    g_alpha, and K1's saved logt and ncomp (T, P). A pixel's walk covers
    rows k < min(ncomp, count): the composite mask is k < ncomp, and K1
    rounds an uncut ncomp up to its 128-row chunk, so the count bounds it
    too. Returns gpairs (B, 6 + C): per stream row, dxy | dconic | dopacity
    | dcolour summed over the tile's pixels; rows no tile walks are zero."""
    T = starts.shape[0]
    C = attrs.shape[1] - 6
    dev = attrs.device
    gpairs = torch.zeros(pair_gidx.shape[0], 6 + C, dtype=torch.float32, device=dev)
    if T == 0:
        return gpairs
    px, py = _pixel_coords(T, tw, ts, dev)
    counts64 = counts.to(torch.int64)
    kstart = torch.minimum(ncomp.to(torch.int64), counts64[:, None])
    tail = torch.exp(logt) * ((g_out * bg).sum(-1) - g_alpha)
    suffix_comp = torch.zeros_like(logt)
    suffix_wgc = torch.zeros_like(logt)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    with full_f32():
        for k in range(int(kstart.max()) - 1, -1, -1):
            walking = counts64 > k
            pos = torch.where(walking, starts.to(torch.int64) + k, 0)
            row = attrs[pair_gidx[pos].to(torch.int64)]  # (T, 6 + C)
            dx = px - row[:, 0:1]
            dy = py - row[:, 1:2]
            sigma = 0.5 * (row[:, 2:3] * dx * dx + row[:, 4:5] * dy * dy) + row[:, 3:4] * dx * dy
            esig = torch.exp(-sigma)
            raw = row[:, 5:6] * esig
            a = torch.clamp(raw, max=ALPHA_CLAMP)
            ok = (kstart > k) & (sigma >= 0.0) & (a >= ALPHA_CUTOFF)
            lt = torch.where(ok, torch.log1p(-a), zero)
            t_before = torch.exp(logt - (suffix_comp + lt))
            w = torch.where(ok, a * t_before, zero)
            gc = torch.einsum("tc,tpc->tp", row[:, 6:], g_out)
            wgc = w * gc
            one_m = torch.clamp(1.0 - a, min=1e-6)
            dalpha = t_before * gc - (suffix_wgc + tail) / one_m
            dalpha = torch.where(ok & (w > 0.0) & (raw < ALPHA_CLAMP), dalpha, zero)
            dsigma = -raw * dalpha
            grads = torch.cat([
                -((row[:, 2:3] * dx + row[:, 3:4] * dy) * dsigma).sum(1, keepdim=True),
                -((row[:, 3:4] * dx + row[:, 4:5] * dy) * dsigma).sum(1, keepdim=True),
                (0.5 * dx * dx * dsigma).sum(1, keepdim=True),
                (dx * dy * dsigma).sum(1, keepdim=True),
                (0.5 * dy * dy * dsigma).sum(1, keepdim=True),
                (esig * dalpha).sum(1, keepdim=True),
                torch.einsum("tp,tpc->tc", w, g_out),
            ], dim=1)
            gpairs[pos[walking]] = grads[walking]
            suffix_comp = suffix_comp + lt
            suffix_wgc = suffix_wgc + wgc
    return gpairs


def _check_bwd_inputs(attrs, starts, g_out, g_alpha, logt, ncomp, ts: int):
    T, P, C = starts.shape[0], ts * ts, attrs.shape[1] - 6
    for name, x, shape in (("g_out", g_out, (T, P, C)), ("g_alpha", g_alpha, (T, P)),
                           ("logt", logt, (T, P)), ("ncomp", ncomp, (T, P))):
        if x.device != attrs.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {attrs.device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} {tuple(x.shape)}: want {shape}")


def _launch_bwd_kernel(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp,
                       tw: int, ts: int):
    C = attrs.shape[1] - 6
    if C not in KERNEL_CHANNELS:
        raise ValueError(f"composite_pairs_bwd kernel is built for C in {KERNEL_CHANNELS}, got {C}")
    if ts * ts > 1024 or (ts * ts) % 32:
        raise ValueError(f"tile_size {ts}: one thread per pixel in whole warps needs "
                         "ts*ts <= 1024 and a multiple of 32")
    from gaussiangrasper_torch._build import load_library

    lib = load_library("composite_pairs_bwd")
    fn = lib.ggt_composite_pairs_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.ggt_cuda_error_string.restype = ctypes.c_char_p
    lib.ggt_cuda_error_string.argtypes = [ctypes.c_int]

    T = starts.shape[0]
    gpairs = torch.zeros(pair_gidx.shape[0], 6 + C, dtype=torch.float32, device=attrs.device)
    if T == 0:
        return gpairs
    stream = torch.cuda.current_stream(attrs.device).cuda_stream
    err = fn(pair_gidx.data_ptr(), starts.data_ptr(), counts.data_ptr(), attrs.data_ptr(),
             bg.data_ptr(), g_out.data_ptr(), g_alpha.data_ptr(), logt.data_ptr(),
             ncomp.data_ptr(), T, tw, ts, C, gpairs.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("composite_pairs_bwd launch failed: "
                           + lib.ggt_cuda_error_string(err).decode())
    composite_pairs_bwd.launches += 1
    return gpairs


def _bwd_dispatch(*args):
    attrs = args[3]
    if attrs.device.type == "cuda":
        return _launch_bwd_kernel(*args)
    if attrs.device.type != "cpu":
        raise ValueError(f"composite_pairs_bwd runs on cuda or cpu, not {attrs.device}")
    return composite_pairs_bwd_plain(*args)


def composite_pairs_bwd(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp,
                        tw: int, ts: int):
    """K2's per-stream-row gradients gpairs (B, 6 + C): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. Arguments as in
    `composite_pairs_bwd_plain`."""
    _check_inputs(pair_gidx, starts, counts, attrs, bg)
    _check_bwd_inputs(attrs, starts, g_out, g_alpha, logt, ncomp, ts)
    return _bwd_dispatch(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp, tw, ts)


composite_pairs_bwd.launches = 0


class _CompositePairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pair_gidx, starts, counts, xys, conics, opacities, colors, bg, tw, ts):
        attrs = pack_attrs(xys, conics, opacities, colors)
        bg = bg.float().contiguous()
        out, alpha, logt, ncomp = composite_pairs_fwd(pair_gidx, starts, counts, attrs, bg, tw, ts)
        ctx.save_for_backward(pair_gidx, starts, counts, attrs, bg, logt, ncomp)
        ctx.tiles = (tw, ts)
        return out, alpha

    @staticmethod
    def backward(ctx, g_out, g_alpha):
        pair_gidx, starts, counts, attrs, bg, logt, ncomp = ctx.saved_tensors
        g_out, g_alpha = g_out.float().contiguous(), g_alpha.float().contiguous()
        # the forward already checked the stream against the table: no second host sync
        _check_bwd_inputs(attrs, starts, g_out, g_alpha, logt, ncomp, ctx.tiles[1])
        gpairs = _bwd_dispatch(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp,
                               *ctx.tiles)
        acc = torch.zeros_like(attrs).index_add_(0, pair_gidx.to(torch.int64), gpairs)
        gbg = torch.einsum("tp,tpc->c", torch.exp(logt), g_out)
        return (None, None, None, acc[:, 0:2], acc[:, 2:5], acc[:, 5], acc[:, 6:], gbg,
                None, None)


def composite_pair_stream(pair_gidx, seg_starts, tile_count, xys, conics, opacities, colors,
                          bg, tw: int, ts: int, k_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile compositing straight off the sorted pair stream; walks
    `stream_bounds` pairs per tile. Returns (out (T, P, C), alpha (T, P))."""
    starts, counts = stream_bounds(pair_gidx, seg_starts, tile_count, k_cap)
    return _CompositePairs.apply(pair_gidx.to(torch.int32).contiguous(), starts, counts,
                                 xys, conics, opacities, colors, bg, tw, ts)
