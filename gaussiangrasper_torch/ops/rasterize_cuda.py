"""Per-tile compositing, forward and backward (counterpart of the JAX
package's ops/rasterize_pallas.py: pair-stream kernels K1, K2, K5 and K6,
table kernels K3 and K4).

`composite_pairs_fwd` (K1, `csrc/composite_pairs_fwd.cu`) and
`composite_pairs_bwd` (K2, `csrc/composite_pairs_bwd.cu`) launch their
hand-written Hopper kernels for CUDA tensors and their plain PyTorch
versions (`composite_pairs_fwd_plain`, `composite_pairs_bwd_plain`) for CPU
tensors; for a CUDA tensor they launch the kernel or raise, never falling
back. Every launch adds one to the wrapper's `launches`.
`composite_pairs_fwd2` (K5) and `composite_pairs_bwd2` (K6) are the
two-tile kernels, in the same two files: the same per-tile body launched
in two-CTA clusters, one tile per CTA. They compute K1's and K2's
functions, so on CPU tensors they run the same plain versions; each has
its own `launches`.

`composite_pair_stream` is the differentiable entry the rasterizer calls:
the forward kernel, the backward kernel, then one `index_add_` by the pair
payload into per-Gaussian gradients and the background gradient
sum_p T_final g_out. `TP` picks the kernels: 1 (default) K1 / K2, 2 K5 / K6,
read once from the GGT_TP environment variable as the JAX package reads
its own `rasterize_pallas.TP`; set the attribute to switch in-process.

The table path walks prebuilt (T, K) per-tile index lists (`tile_gidx`,
-1 padded) instead of the stream. `composite_binned` is its
differentiable entry: one fused row gather into a packed (T, K, 6 + C)
table (`gather_tables`), `composite_tables_fwd` (K3), and in the backward
`composite_tables_bwd` (K4) into a (T, K, 6 + C) gradient table, one
`index_add_` by tile_gidx and the background gradient. K3 / K4 are K1 /
K2's per-tile bodies with the table as their row source, so their plain
versions are K1 / K2's, run on the table as a stream (row t K + k). The
table needs no padding to the TPU's 128-row chunk: the walks stop at the
count. `composite_tiles` is K3 alone over pre-gathered per-tile arrays.

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
import os
from typing import Dict, Tuple

import torch

from gaussiangrasper_torch._build import check_error as _check, entry as _entry
from gaussiangrasper_torch._device import full_f32
from gaussiangrasper_torch.ops.rasterize import ALPHA_CLAMP, ALPHA_CUTOFF, _LOG_EPS

WALK_CHUNK = 128
"""K1 walks 128-row chunks and counts the zero-alpha rows past `count` in
its last chunk as composited, so an uncut pixel's ncomp is the walk length
rounded up to this. The port reproduces that count exactly."""

KERNEL_CHANNELS = (3, 39)
"""Channel counts the kernels are instantiated for (rgb; rgb + 32-d feature
+ depth + normal). Any other C raises on a CUDA tensor."""

TABLE_FWD_CHANNELS = (3, 7, 39)
"""K3's channel counts: KERNEL_CHANNELS and the kernel probe's C = 7."""


def tiles_per_instance(value) -> int:
    """The `TP` setting: 1 or 2 tiles per kernel instance; anything else raises."""
    tp = int(value)
    if tp not in (1, 2):
        raise ValueError(f"GGT_TP / rasterize_cuda.TP must be 1 or 2, got {value!r}")
    return tp


TP = tiles_per_instance(os.environ.get("GGT_TP", "1"))
"""Tiles per compositor kernel instance: 1 runs K1 / K2, 2 runs K5 / K6."""


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


_clusters: Dict[Tuple[str, int, int], int] = {}


def max_active_clusters(kernel: str, channels: int, ts: int) -> int:
    """cudaOccupancyMaxActiveClusters of the two-tile kernel `kernel`
    ("fwd2" for K5, "bwd2" for K6) at this C and tile size: how many
    two-CTA clusters the current card holds at once."""
    key = (kernel, channels, ts)
    if key not in _clusters:
        source = {"fwd2": "composite_pairs_fwd", "bwd2": "composite_pairs_bwd"}[kernel]
        lib, fn = _entry(source, f"ggt_composite_pairs_{kernel}_max_clusters",
                         [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        n = ctypes.c_int(0)
        _check(lib, fn(channels, ts, ctypes.byref(n)), f"cudaOccupancyMaxActiveClusters ({kernel})")
        _clusters[key] = n.value
    return _clusters[key]


def _require_clusters(kernel: str, channels: int, ts: int) -> None:
    if max_active_clusters(kernel, channels, ts) == 0:
        raise RuntimeError(f"composite_pairs_{kernel}: no two-CTA cluster of this kernel fits "
                           f"on the card (C {channels}, tile {ts}); run with TP = 1")


def _launch_kernel(pair_gidx, starts, counts, attrs, bg, tw: int, ts: int, two_tile: bool = False):
    """K1, or K5 with `two_tile`."""
    C = attrs.shape[1] - 6
    name = "composite_pairs_fwd2" if two_tile else "composite_pairs_fwd"
    if C not in KERNEL_CHANNELS:
        raise ValueError(f"{name} kernel is built for C in {KERNEL_CHANNELS}, got {C}")
    if ts * ts > 1024:
        raise ValueError(f"tile_size {ts}: one thread per pixel needs ts*ts <= 1024")
    lib, fn = _entry("composite_pairs_fwd", f"ggt_{name}",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5)
    if two_tile:
        _require_clusters("fwd2", C, ts)

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
    _check(lib, err, f"{name} launch")
    (composite_pairs_fwd2 if two_tile else composite_pairs_fwd).launches += 1
    return out, alpha, logt, ncomp


def _launch_kernel2(pair_gidx, starts, counts, attrs, bg, tw: int, ts: int):
    """K5: K1's arguments and outputs, two tiles per two-CTA cluster."""
    return _launch_kernel(pair_gidx, starts, counts, attrs, bg, tw, ts, two_tile=True)


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


def composite_pairs_fwd2(pair_gidx, starts, counts, attrs, bg, tw: int, ts: int):
    """K5: K1's function and outputs, the two-tile CUDA kernel for CUDA
    tensors, K1's plain version for CPU tensors."""
    _check_inputs(pair_gidx, starts, counts, attrs, bg)
    if attrs.device.type == "cuda":
        return _launch_kernel2(pair_gidx, starts, counts, attrs, bg, tw, ts)
    if attrs.device.type != "cpu":
        raise ValueError(f"composite_pairs_fwd2 runs on cuda or cpu, not {attrs.device}")
    return composite_pairs_fwd_plain(pair_gidx, starts, counts, attrs, bg, tw, ts)


composite_pairs_fwd2.launches = 0


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


def _check_bwd_inputs(device, T: int, C: int, g_out, g_alpha, logt, ncomp, ts: int):
    P = ts * ts
    for name, x, shape in (("g_out", g_out, (T, P, C)), ("g_alpha", g_alpha, (T, P)),
                           ("logt", logt, (T, P)), ("ncomp", ncomp, (T, P))):
        if x.device != device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} {tuple(x.shape)}: want {shape}")


def _launch_bwd_kernel(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp,
                       tw: int, ts: int, two_tile: bool = False):
    """K2, or K6 with `two_tile`."""
    C = attrs.shape[1] - 6
    name = "composite_pairs_bwd2" if two_tile else "composite_pairs_bwd"
    if C not in KERNEL_CHANNELS:
        raise ValueError(f"{name} kernel is built for C in {KERNEL_CHANNELS}, got {C}")
    if ts * ts > 1024 or (ts * ts) % 32:
        raise ValueError(f"tile_size {ts}: one thread per pixel in whole warps needs "
                         "ts*ts <= 1024 and a multiple of 32")
    lib, fn = _entry("composite_pairs_bwd", f"ggt_{name}",
                     [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    if two_tile:
        _require_clusters("bwd2", C, ts)

    T = starts.shape[0]
    gpairs = torch.zeros(pair_gidx.shape[0], 6 + C, dtype=torch.float32, device=attrs.device)
    if T == 0:
        return gpairs
    stream = torch.cuda.current_stream(attrs.device).cuda_stream
    err = fn(pair_gidx.data_ptr(), starts.data_ptr(), counts.data_ptr(), attrs.data_ptr(),
             bg.data_ptr(), g_out.data_ptr(), g_alpha.data_ptr(), logt.data_ptr(),
             ncomp.data_ptr(), T, tw, ts, C, gpairs.data_ptr(), stream)
    _check(lib, err, f"{name} launch")
    (composite_pairs_bwd2 if two_tile else composite_pairs_bwd).launches += 1
    return gpairs


def _launch_bwd_kernel2(*args):
    """K6: K2's arguments and output, two tiles per two-CTA cluster."""
    return _launch_bwd_kernel(*args, two_tile=True)


def _bwd_dispatch(*args, two_tile: bool = False):
    attrs = args[3]
    if attrs.device.type == "cuda":
        return _launch_bwd_kernel(*args, two_tile=two_tile)
    if attrs.device.type != "cpu":
        raise ValueError(f"composite_pairs_bwd runs on cuda or cpu, not {attrs.device}")
    return composite_pairs_bwd_plain(*args)


def composite_pairs_bwd(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp,
                        tw: int, ts: int):
    """K2's per-stream-row gradients gpairs (B, 6 + C): the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. Arguments as in
    `composite_pairs_bwd_plain`."""
    _check_inputs(pair_gidx, starts, counts, attrs, bg)
    _check_bwd_inputs(attrs.device, starts.shape[0], attrs.shape[1] - 6, g_out, g_alpha, logt,
                      ncomp, ts)
    return _bwd_dispatch(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp, tw, ts)


composite_pairs_bwd.launches = 0


def composite_pairs_bwd2(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp,
                         tw: int, ts: int):
    """K6: K2's function and output, the two-tile CUDA kernel for CUDA
    tensors, K2's plain version for CPU tensors."""
    _check_inputs(pair_gidx, starts, counts, attrs, bg)
    _check_bwd_inputs(attrs.device, starts.shape[0], attrs.shape[1] - 6, g_out, g_alpha, logt,
                      ncomp, ts)
    return _bwd_dispatch(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp, tw, ts,
                         two_tile=True)


composite_pairs_bwd2.launches = 0


class _CompositePairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pair_gidx, starts, counts, xys, conics, opacities, colors, bg, tw, ts):
        attrs = pack_attrs(xys, conics, opacities, colors)
        bg = bg.float().contiguous()
        ctx.two_tile = tiles_per_instance(TP) == 2
        fwd = composite_pairs_fwd2 if ctx.two_tile else composite_pairs_fwd
        out, alpha, logt, ncomp = fwd(pair_gidx, starts, counts, attrs, bg, tw, ts)
        ctx.save_for_backward(pair_gidx, starts, counts, attrs, bg, logt, ncomp)
        ctx.tiles = (tw, ts)
        return out, alpha

    @staticmethod
    def backward(ctx, g_out, g_alpha):
        pair_gidx, starts, counts, attrs, bg, logt, ncomp = ctx.saved_tensors
        g_out, g_alpha = g_out.float().contiguous(), g_alpha.float().contiguous()
        # the forward already checked the stream against the table: no second host sync
        _check_bwd_inputs(attrs.device, starts.shape[0], attrs.shape[1] - 6, g_out, g_alpha, logt,
                          ncomp, ctx.tiles[1])
        gpairs = _bwd_dispatch(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp,
                               *ctx.tiles, two_tile=ctx.two_tile)
        acc = torch.zeros_like(attrs).index_add_(0, pair_gidx.to(torch.int64), gpairs)
        gbg = torch.einsum("tp,tpc->c", torch.exp(logt), g_out)
        return (None, None, None, acc[:, 0:2], acc[:, 2:5], acc[:, 5], acc[:, 6:], gbg,
                None, None)


def composite_pair_stream(pair_gidx, seg_starts, tile_count, xys, conics, opacities, colors,
                          bg, tw: int, ts: int, k_cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile compositing straight off the sorted pair stream; walks
    `stream_bounds` pairs per tile, through K1 / K2 or, with `TP` 2, K5 / K6.
    Returns (out (T, P, C), alpha (T, P))."""
    starts, counts = stream_bounds(pair_gidx, seg_starts, tile_count, k_cap)
    return _CompositePairs.apply(pair_gidx.to(torch.int32).contiguous(), starts, counts,
                                 xys, conics, opacities, colors, bg, tw, ts)


# --- the table path: K3 / K4 -------------------------------------------------------


def gather_tables(tile_gidx, xys, conics, opacities, colors) -> torch.Tensor:
    """ONE fused row gather of the packed (T, K, 6 + C) attribute table from
    tile_gidx (T, K), -1 padded: a -1 slot becomes a zero row (a zero
    opacity, which the walks skip)."""
    attrs = pack_attrs(xys, conics, opacities, colors)
    n, a = attrs.shape
    rows = torch.cat([attrs, attrs.new_zeros(1, a)])  # row n: the zero row of a -1 slot
    idx = torch.where(tile_gidx >= 0, tile_gidx, n).reshape(-1).to(torch.int64)
    return rows.index_select(0, idx).view(*tile_gidx.shape, a)


def _table_stream(tables):
    """The (T, Kt, A) table as a pair stream for K1 / K2's plain versions:
    row k of tile t is stream row t Kt + k."""
    t, kt, a = tables.shape
    dev = tables.device
    gidx = torch.arange(t * kt, dtype=torch.int32, device=dev)
    starts = torch.arange(t, dtype=torch.int32, device=dev) * kt
    return gidx, starts, tables.reshape(t * kt, a)


def composite_tables_fwd_plain(counts, tables, bg, tw: int, ts: int, count_live: bool = False):
    """Plain PyTorch version of K3: K1's plain version walking rows
    [0, counts[t]) of tile t's table. counts (T,) int32 <= Kt; tables (T,
    Kt, 6 + C); bg (C,). Returns out (T, P, C), alpha, logt, ncomp (T, P)
    (+ the live counts with `count_live`), as K1's."""
    gidx, starts, attrs = _table_stream(tables)
    return composite_pairs_fwd_plain(gidx, starts, counts, attrs, bg, tw, ts, count_live)


def composite_tables_bwd_plain(counts, tables, bg, g_out, g_alpha, logt, ncomp, tw: int, ts: int):
    """Plain PyTorch version of K4: K2's plain version on the table's rows.
    Returns gattr (T, Kt, 6 + C); rows no pixel walks are zero."""
    gidx, starts, attrs = _table_stream(tables)
    return composite_pairs_bwd_plain(gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp,
                                     tw, ts).view(tables.shape)


def _check_table_inputs(counts, tables, bg):
    dev = tables.device
    for name, x, dt in (("counts", counts, torch.int32), ("tables", tables, torch.float32),
                        ("bg", bg, torch.float32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, tables on {dev}")
        if x.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tables.ndim != 3 or bg.shape != (tables.shape[2] - 6,) or counts.shape != tables.shape[:1]:
        raise ValueError(f"counts {tuple(counts.shape)} / tables {tuple(tables.shape)} / bg "
                         f"{tuple(bg.shape)}: want (T,) / (T, K, 6+C) / (C,)")
    # the kernels read rows [0, counts[t]) of tile t without bounds checks: one sync
    if counts.numel() and bool((counts < 0).any() | (counts > tables.shape[1]).any()):
        raise ValueError(f"counts must lie in [0, {tables.shape[1]}] (the table's K)")


def _launch_table_fwd(counts, tables, bg, tw: int, ts: int):
    T, kt, a = tables.shape
    C = a - 6
    if C not in TABLE_FWD_CHANNELS:
        raise ValueError(f"composite_tables_fwd kernel is built for C in {TABLE_FWD_CHANNELS}, "
                         f"got {C}")
    if ts * ts > 1024:
        raise ValueError(f"tile_size {ts}: one thread per pixel needs ts*ts <= 1024")
    lib, fn = _entry("composite_pairs_fwd", "ggt_composite_tables_fwd",
                     [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5)
    P = ts * ts
    out = torch.empty(T, P, C, dtype=torch.float32, device=tables.device)
    alpha, logt, ncomp = (torch.empty(T, P, dtype=torch.float32, device=tables.device)
                          for _ in range(3))
    if T == 0:
        return out, alpha, logt, ncomp
    stream = torch.cuda.current_stream(tables.device).cuda_stream
    err = fn(counts.data_ptr(), tables.data_ptr(), bg.data_ptr(), T, kt, tw, ts, C,
             out.data_ptr(), alpha.data_ptr(), logt.data_ptr(), ncomp.data_ptr(), stream)
    _check(lib, err, "composite_tables_fwd launch")
    composite_tables_fwd.launches += 1
    return out, alpha, logt, ncomp


def composite_tables_fwd(counts, tables, bg, tw: int, ts: int):
    """K3's four outputs (out (T, P, C), alpha, logt, ncomp (T, P)): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Arguments as in `composite_tables_fwd_plain`."""
    _check_table_inputs(counts, tables, bg)
    if tables.device.type == "cuda":
        return _launch_table_fwd(counts, tables, bg, tw, ts)
    if tables.device.type != "cpu":
        raise ValueError(f"composite_tables_fwd runs on cuda or cpu, not {tables.device}")
    return composite_tables_fwd_plain(counts, tables, bg, tw, ts)


composite_tables_fwd.launches = 0


def _launch_table_bwd(counts, tables, bg, g_out, g_alpha, logt, ncomp, tw: int, ts: int):
    T, kt, a = tables.shape
    C = a - 6
    if C not in KERNEL_CHANNELS:
        raise ValueError(f"composite_tables_bwd kernel is built for C in {KERNEL_CHANNELS}, "
                         f"got {C}")
    if ts * ts > 1024 or (ts * ts) % 32:
        raise ValueError(f"tile_size {ts}: one thread per pixel in whole warps needs "
                         "ts*ts <= 1024 and a multiple of 32")
    lib, fn = _entry("composite_pairs_bwd", "ggt_composite_tables_bwd",
                     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
    gattr = torch.zeros_like(tables)
    if T == 0:
        return gattr
    stream = torch.cuda.current_stream(tables.device).cuda_stream
    err = fn(counts.data_ptr(), tables.data_ptr(), bg.data_ptr(), g_out.data_ptr(),
             g_alpha.data_ptr(), logt.data_ptr(), ncomp.data_ptr(), T, kt, tw, ts, C,
             gattr.data_ptr(), stream)
    _check(lib, err, "composite_tables_bwd launch")
    composite_tables_bwd.launches += 1
    return gattr


def _table_bwd_dispatch(*args):
    tables = args[1]
    if tables.device.type == "cuda":
        return _launch_table_bwd(*args)
    if tables.device.type != "cpu":
        raise ValueError(f"composite_tables_bwd runs on cuda or cpu, not {tables.device}")
    return composite_tables_bwd_plain(*args)


def composite_tables_bwd(counts, tables, bg, g_out, g_alpha, logt, ncomp, tw: int, ts: int):
    """K4's per-(tile, slot) gradients gattr (T, Kt, 6 + C): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. g_out (T, P, C),
    g_alpha and K3's logt and ncomp (T, P)."""
    _check_table_inputs(counts, tables, bg)
    _check_bwd_inputs(tables.device, tables.shape[0], tables.shape[2] - 6, g_out, g_alpha, logt,
                      ncomp, ts)
    return _table_bwd_dispatch(counts, tables, bg, g_out, g_alpha, logt, ncomp, tw, ts)


composite_tables_bwd.launches = 0


def scatter_table(tile_gidx, n: int, gattr):
    """The (n, 6 + C) per-Gaussian sum of a (T, K, 6 + C) gradient table:
    ONE scatter-add by tile_gidx. A -1 slot k goes to dump row n + k, dropped
    after: one shared dump row serializes the atomics of every padding slot
    (over a third of the table at the bench point)."""
    k, a = gattr.shape[1], gattr.shape[2]
    dump = n + torch.arange(k, device=tile_gidx.device)
    idx = torch.where(tile_gidx >= 0, tile_gidx, dump).reshape(-1).to(torch.int64)
    return gattr.new_zeros(n + k, a).index_add_(0, idx, gattr.reshape(-1, a))[:n]


class _CompositeBinned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tile_gidx, counts, xys, conics, opacities, colors, bg, tw, ts):
        tables = gather_tables(tile_gidx, xys, conics, opacities, colors)
        bg = bg.float().contiguous()
        out, alpha, logt, ncomp = composite_tables_fwd(counts, tables, bg, tw, ts)
        ctx.save_for_backward(tile_gidx, counts, tables, bg, logt, ncomp)
        ctx.tiles = (tw, ts)
        ctx.n = xys.shape[0]
        return out, alpha

    @staticmethod
    def backward(ctx, g_out, g_alpha):
        tile_gidx, counts, tables, bg, logt, ncomp = ctx.saved_tensors
        g_out, g_alpha = g_out.float().contiguous(), g_alpha.float().contiguous()
        # the forward already checked counts against the table: no second host sync
        _check_bwd_inputs(tables.device, tables.shape[0], tables.shape[2] - 6, g_out, g_alpha,
                          logt, ncomp, ctx.tiles[1])
        gattr = _table_bwd_dispatch(counts, tables, bg, g_out, g_alpha, logt, ncomp, *ctx.tiles)
        acc = scatter_table(tile_gidx, ctx.n, gattr)
        gbg = torch.einsum("tp,tpc->c", torch.exp(logt), g_out)
        return (None, None, acc[:, 0:2], acc[:, 2:5], acc[:, 5], acc[:, 6:], gbg, None, None)


def composite_binned(tile_gidx, tile_count, xys, conics, opacities, colors, bg, tw: int,
                     ts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable per-tile compositing off the binning table: tile_gidx
    (T, K) int32, -1 padded; tile_count (T,) int32 (walks min(tile_count,
    K) slots). Forward K3, backward K4. Returns (out (T, P, C), alpha (T, P))."""
    counts = torch.clamp(tile_count, max=tile_gidx.shape[1]).to(torch.int32).contiguous()
    return _CompositeBinned.apply(tile_gidx.to(torch.int32).contiguous(), counts, xys, conics,
                                  opacities, colors, bg, tw, ts)


def composite_tiles(counts, tile_xy, tile_con, tile_opac, tile_col, bg, tw: int, ts: int):
    """K3 alone over pre-gathered per-tile arrays (the kernel probe's entry):
    counts (T,), tile_xy (T, K, 2), tile_con (T, K, 3), tile_opac (T, K),
    tile_col (T, K, C), bg (C,). Not differentiable. Returns (out, alpha)."""
    tables = torch.cat([tile_xy, tile_con, tile_opac[..., None], tile_col], -1).float().contiguous()
    out, alpha, _, _ = composite_tables_fwd(counts.to(torch.int32).contiguous(), tables,
                                            bg.float().contiguous(), tw, ts)
    return out, alpha
