"""Per-tile compositing, forward and backward (counterpart of the JAX
package's ops/rasterize_pallas.py: pair-stream kernels K1, K2, K5 and K6,
table kernels K3 and K4).

`composite_pairs_fwd` (K1, `csrc/composite_pairs_fwd.cu`) and
`composite_pairs_bwd` (K2, `csrc/composite_pairs_bwd.cu`) launch their
hand-written Hopper kernels for CUDA tensors and their plain PyTorch
versions (`composite_pairs_fwd_plain`, `composite_pairs_bwd_plain`) for CPU
tensors (`_device.use_kernel`); for a CUDA tensor they launch the kernel or
raise, never falling back. With `two_tile` they launch the two-tile kernels
K5 / K6, in the same two files: the same per-tile body launched in
clusters that hold two tiles (K5: two CTAs, the same part of each of the
two tiles; K6: four, two a tile, as K2 runs two CTAs a tile). They compute
K1's and K2's functions, so on CPU tensors `two_tile` changes nothing.
Every launch goes through `_build.launch`, whose counter keys it by its C
entry (`ggt_composite_pairs_fwd`, `ggt_composite_pairs_fwd2`, ...).

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

from gaussiangrasper_torch._build import check_error as _check, entry as _entry, launch
from gaussiangrasper_torch._device import full_f32, use_kernel
from gaussiangrasper_torch.ops.rasterize import ALPHA_CLAMP, ALPHA_CUTOFF, _LOG_EPS
from gaussiangrasper_torch.utils.profiler import PROFILER

WALK_CHUNK = 128
"""K1 walks 128-row chunks and counts the zero-alpha rows past `count` in
its last chunk as composited, so an uncut pixel's ncomp is the walk length
rounded up to this. The port reproduces that count exactly."""

KERNEL_CHANNELS = (3, 39)
"""Channel counts the kernels are instantiated for (rgb; rgb + 32-d feature
+ depth + normal). The wrappers cut the C colour channels into pieces of at
most 39 (`channel_pieces`), write each piece zero-padded up to the next of
these (`cut_channels`) and launch the kernel once a piece."""

TABLE_FWD_CHANNELS = (3, 7, 39)
"""K3's channel counts: KERNEL_CHANNELS and the kernel probe's C = 7."""

MAX_CHANNELS = 122
"""The widest C the JAX package composites: its pair rows hold the 6 + C
attributes in 128 lanes (rasterize_pallas._gather_pairs). A feature dim of
at most 115."""


def check_channels(c: int) -> None:
    if c > MAX_CHANNELS:
        raise ValueError(f"C {c} colour channels: the attribute row of 6 + C = {6 + c} values "
                         f"exceeds the JAX package's 128-value row (C <= {MAX_CHANNELS}, a "
                         f"feature dim of at most {MAX_CHANNELS - 7})")


def channel_pieces(c: int):
    """[(lo, hi)]: the colour channels [0, c) in pieces of at most
    KERNEL_CHANNELS[-1], one kernel launch each."""
    step = KERNEL_CHANNELS[-1]
    return [(lo, min(lo + step, c)) for lo in range(0, c, step)] or [(0, c)]


def channel_width(built, c: int) -> int:
    """The smallest instantiated channel count in `built` at or above c."""
    return next(k for k in built if k >= c)


def cut_channels(x: torch.Tensor, lo: int, hi: int, width: int, lead: int = 6) -> torch.Tensor:
    """x (..., lead + C) as (..., lead + width): its `lead` leading columns
    (attrs and tables: the 6 geometric ones; bg and g_out: none), then its
    colour channels [lo, hi), then zeros up to `width`, written once into
    a new buffer; x itself where that is all of x. Zero channels composite
    to zero and take zero gradient, and <c, g> gains only zero terms, so
    the kernel's first hi - lo channels and the geometric gradients are
    those of the piece alone."""
    n = hi - lo
    if lo == 0 and n == width == x.shape[-1] - lead:
        return x
    y = torch.empty(x.shape[:-1] + (lead + width,), dtype=x.dtype, device=x.device)
    y[..., :lead] = x[..., :lead]
    y[..., lead:lead + n] = x[..., lead + lo:lead + hi]
    y[..., lead + n:] = 0
    return y


def fwd_pieces(kernel, built, rows: torch.Tensor, bg: torch.Tensor):
    """The forward in channel pieces: for each (lo, hi) of `channel_pieces`,
    kernel(rows', bg') on the piece's rows and bg (`cut_channels`, to a
    width in `built`) gives (out, alpha, logt, ncomp). Returns the pieces'
    outs side by side (..., C) and each piece's (alpha, logt, ncomp): the
    weights depend on the geometry alone, so these are the same for every
    piece."""
    c = rows.shape[-1] - 6
    pieces, weights, joined = channel_pieces(c), [], None
    for lo, hi in pieces:
        width = channel_width(built, hi - lo)
        out, *rest = kernel(cut_channels(rows, lo, hi, width), cut_channels(bg, lo, hi, width, 0))
        weights.append(tuple(rest))
        if len(pieces) == 1 and width == c:
            joined = out
            break
        if joined is None:
            joined = torch.empty(out.shape[:-1] + (c,), dtype=out.dtype, device=out.device)
        joined[..., lo:hi] = out[..., :hi - lo]
    return joined, weights


def bwd_pieces(kernel, rows: torch.Tensor, bg: torch.Tensor, g_out: torch.Tensor,
               g_alpha: torch.Tensor) -> torch.Tensor:
    """The backward in channel pieces: kernel(rows', bg', g_out', g_alpha')
    on each piece (`cut_channels`, to a width in KERNEL_CHANNELS) gives its
    (..., 6 + width) gradients. Every gradient is linear in (g_out,
    g_alpha) and <c, g> and <bg, g_out> are sums over channels, so the
    geometric columns 0-5 are the sum over pieces, with g_alpha given to
    the first piece only (zeros to the others: its term counts once), and
    the colour columns are each piece's own."""
    c = rows.shape[-1] - 6
    pieces, grads, ga = channel_pieces(c), None, g_alpha
    for i, (lo, hi) in enumerate(pieces):
        width = channel_width(KERNEL_CHANNELS, hi - lo)
        g = kernel(cut_channels(rows, lo, hi, width), cut_channels(bg, lo, hi, width, 0),
                   cut_channels(g_out, lo, hi, width, 0), ga)
        if len(pieces) == 1 and width == c:
            return g
        if grads is None:
            grads = torch.empty(g.shape[:-1] + (6 + c,), dtype=g.dtype, device=g.device)
            grads[..., :6] = g[..., :6]
        else:
            grads[..., :6] += g[..., :6]
        grads[..., 6 + lo:6 + hi] = g[..., 6:6 + hi - lo]
        if i == 0 and len(pieces) > 1:
            ga = torch.zeros_like(g_alpha)
    return grads


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


def warp_pixels(ts: int, device=None) -> torch.Tensor:
    """(P,) tile pixel of each thread of a compositor kernel's tile, as
    `tile_pixel` (csrc/mma_tf32.cuh) places them: warp w covers the 8 x 4
    pixel block w of the tile (blocks in row-major order), lane l its pixel
    (l % 8, l // 8). ts is a multiple of 8."""
    lin = torch.arange(ts * ts, device=device)
    w, lane, bw = lin // 32, lin % 32, ts // 8
    return ((w // bw) * 4 + lane // 8) * ts + (w % bw) * 8 + lane % 8


def composite_pairs_fwd_plain(pair_gidx, starts, counts, attrs, bg, tw: int, ts: int,
                              count_live: bool = False, count_warp_rows: bool = False):
    """Plain PyTorch version of the kernel, one walk step per stream row,
    vectorized over every tile and pixel, in the kernel's operation order.

    pair_gidx (B,) int32; starts, counts (T,) int32 with counts <= B - starts;
    attrs (N, 6 + C) rows xy | conic (a, b, c) | opacity | colour; bg (C,).
    Returns out (T, P, C), alpha, logt, ncomp (T, P) float32, plus, with
    `count_live`, the per-pixel number of composited entries with nonzero
    alpha (the walk's work, for the roofline bound), and with
    `count_warp_rows` a dict of the kernel's work under its 8 x 4 pixel
    warps (`warp_pixels`, ts a multiple of 8), as its per-warp cull and
    product groups see it:
      warp_rows       warp x row pairs that some lane walks (up to and
                      including its cut row);
      live_warp_rows  those in which a lane composites;
      kept_warp_rows  those whose cull box (`cull_box`) meets the warp's
                      pixel bounds: the rows the warp evaluates;
      kept_visits     pixel x row pairs of walking lanes in kept rows;
      box_tests       row tests of the cull: every row of each 32-row
                      window (32-aligned in the walk) that a warp enters
                      with a lane still walking;
      products        the colour products: each warp's kept rows of a
                      window, 8 at a time, a group with a lane that
                      composites one of them taking one."""
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
    if count_warp_rows:
        by_warp = warp_pixels(ts, dev)
        wx, wy = px[:, by_warp].view(T, -1, 32), py[:, by_warp].view(T, -1, 32)
        bounds = (wx.amin(-1), wx.amax(-1), wy.amin(-1), wy.amax(-1))  # (T, W) each
        work = dict.fromkeys(("warp_rows", "live_warp_rows", "kept_warp_rows", "kept_visits",
                              "box_tests", "products"), 0)
        in_window = torch.zeros(bounds[0].shape, dtype=torch.bool, device=dev)
        group_rows = torch.zeros(bounds[0].shape, dtype=torch.int64, device=dev)
        group_live = torch.zeros_like(in_window)
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
        acc = acc + torch.einsum("tp,tc->tpc", w, row[:, 6:])  # the kernels' colour product
        logt = torch.where(comp, logt + lt, logt)
        cum_all = torch.where(comp, cum, cum_all)
        cut = torch.where(crossed, k, cut)
        live = live + comp.to(torch.int64)
        if count_warp_rows:
            walk_w = walking[:, by_warp].view(T, -1, 32)
            alive = walk_w.any(-1)  # (T, W): the warp has a lane still walking
            comp_w = comp[:, by_warp].view(T, -1, 32).any(-1)
            if k % 32 == 0:  # a new window: the open groups end
                work["products"] += int(group_live.sum())
                group_live.zero_()
                group_rows.zero_()
                in_window = alive
            bx, by = cull_box(row[:, 2], row[:, 3], row[:, 4], row[:, 5])
            x, y = row[:, 0:1], row[:, 1:2]
            kept = alive & (counts64 > k)[:, None] & ~(
                (x + bx[:, None] < bounds[0]) | (x - bx[:, None] > bounds[1])
                | (y + by[:, None] < bounds[2]) | (y - by[:, None] > bounds[3]))
            group_live |= comp_w & kept
            group_rows += kept
            full = kept & (group_rows % 8 == 0)
            work["products"] += int((group_live & full).sum())
            group_live &= ~full
            work["warp_rows"] += int(alive.sum())
            work["live_warp_rows"] += int(comp_w.sum())
            work["kept_warp_rows"] += int(kept.sum())
            work["kept_visits"] += int((walk_w & kept[..., None]).sum())
            work["box_tests"] += int((in_window & (counts64 > k)[:, None]).sum())
    t_final = torch.exp(logt)
    out = acc + t_final[..., None] * bg
    walk_len = (counts64 + WALK_CHUNK - 1) // WALK_CHUNK * WALK_CHUNK
    ncomp = torch.where(cut >= 0, cut, walk_len[:, None]).to(torch.float32)
    res = (out, 1.0 - t_final, logt, ncomp)
    if count_live:
        res = res + (live,)
    if count_warp_rows:
        work["products"] += int(group_live.sum())
        res = res + (work,)
    return res


def cull_box(a, b, c, o):
    """The forward kernel's cull box (`cull_box` in
    csrc/composite_pairs_fwd.cu) of rows with conic (a, b, c) and opacity
    o: half-extents (rx, ry) around the row's centre outside which no
    pixel passes the alpha test (alpha >= 1/255 needs sigma <= log(255 o)),
    widened by a margin; unbounded where the conic is not safely positive
    definite, (-1, -1) where o < 1/255."""
    det = a * c - b * b
    l2 = 2.0 * (torch.log(255.0 * o) + 0.05)
    bounded = (a > 0.0) & (c > 0.0) & (det > 1e-4 * a * c)
    rx = torch.where(bounded, torch.sqrt(l2 * c / det) * 1.001 + 1e-3, torch.inf)
    ry = torch.where(bounded, torch.sqrt(l2 * a / det) * 1.001 + 1e-3, torch.inf)
    empty = ~(o >= ALPHA_CUTOFF)
    return torch.where(empty, -1.0, rx), torch.where(empty, -1.0, ry)


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
    check_channels(attrs.shape[1] - 6)
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
    ("fwd2" for K5: two-CTA clusters; "bwd2" for K6: four-CTA clusters,
    two a tile) at this C and tile size: how many clusters the current
    card holds at once."""
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
        raise RuntimeError(f"composite_pairs_{kernel}: no cluster of this kernel fits "
                           f"on the card (C {channels}, tile {ts}); run with TP = 1")


def _launch_kernel(pair_gidx, starts, counts, attrs, bg, tw: int, ts: int, two_tile: bool = False):
    """K1, or K5 with `two_tile`, at any C <= MAX_CHANNELS: one launch a
    channel piece (`fwd_pieces`)."""
    if ts * ts > 1024:
        raise ValueError(f"tile_size {ts}: one thread per pixel needs ts*ts <= 1024")
    out, weights = fwd_pieces(
        lambda a, b: _kernel_fwd(pair_gidx, starts, counts, a, b, tw, ts, two_tile),
        KERNEL_CHANNELS, attrs, bg)
    return (out,) + weights[0]


def _kernel_fwd(pair_gidx, starts, counts, attrs, bg, tw: int, ts: int, two_tile: bool):
    """The launch of K1 / K5 at an instantiated C."""
    C = attrs.shape[1] - 6
    if two_tile:
        _require_clusters("fwd2", C, ts)

    T = starts.shape[0]
    P = ts * ts
    out = torch.empty(T, P, C, dtype=torch.float32, device=attrs.device)
    alpha, logt, ncomp = (torch.empty(T, P, dtype=torch.float32, device=attrs.device)
                          for _ in range(3))
    if T == 0:
        return out, alpha, logt, ncomp
    name = "ggt_composite_pairs_fwd2" if two_tile else "ggt_composite_pairs_fwd"
    launch("composite_pairs_fwd", name,
           [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4,
           pair_gidx.data_ptr(), starts.data_ptr(), counts.data_ptr(), attrs.data_ptr(),
           bg.data_ptr(), T, tw, ts, C, out.data_ptr(), alpha.data_ptr(), logt.data_ptr(),
           ncomp.data_ptr(), device=attrs.device)
    return out, alpha, logt, ncomp


def composite_pairs_fwd(pair_gidx, starts, counts, attrs, bg, tw: int, ts: int,
                        two_tile: bool = False):
    """K1's four outputs (out (T, P, C), alpha, logt, ncomp (T, P)): the
    CUDA kernel for CUDA tensors (K5 with `two_tile`), the plain version
    for CPU tensors. Arguments as in `composite_pairs_fwd_plain`."""
    kernel = use_kernel(attrs.device, "composite_pairs_fwd")
    _check_inputs(pair_gidx, starts, counts, attrs, bg)
    if kernel:
        return _launch_kernel(pair_gidx, starts, counts, attrs, bg, tw, ts, two_tile)
    return composite_pairs_fwd_plain(pair_gidx, starts, counts, attrs, bg, tw, ts)


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
                              tw: int, ts: int, count_warp_rows: bool = False):
    """Plain PyTorch version of K2: the reverse walk, one stream row at a
    time from the last composited row down to 0, vectorized over every
    tile and pixel, in the kernel's operation order.

    Stream inputs as in `composite_pairs_fwd_plain`; g_out (T, P, C),
    g_alpha, and K1's saved logt and ncomp (T, P). A pixel's walk covers
    rows k < min(ncomp, count): the composite mask is k < ncomp, and K1
    rounds an uncut ncomp up to its 128-row chunk, so the count bounds it
    too. Returns gpairs (B, 6 + C): per stream row, dxy | dconic | dopacity
    | dcolour summed over the tile's pixels; rows no tile walks are zero.
    With `count_warp_rows`, also the kernel's work in warp x row pairs (a
    warp an 8 x 4 pixel block, `warp_pixels`): those some lane
    walks, and those with a lane whose row passes the validity tests (the
    live ones)."""
    T = starts.shape[0]
    C = attrs.shape[1] - 6
    dev = attrs.device
    gpairs = torch.zeros(pair_gidx.shape[0], 6 + C, dtype=torch.float32, device=dev)
    if T == 0:
        return (gpairs, 0, 0) if count_warp_rows else gpairs
    px, py = _pixel_coords(T, tw, ts, dev)
    counts64 = counts.to(torch.int64)
    kstart = torch.minimum(ncomp.to(torch.int64), counts64[:, None])
    tail = torch.exp(logt) * ((g_out * bg).sum(-1) - g_alpha)
    suffix_comp = torch.zeros_like(logt)
    suffix_wgc = torch.zeros_like(logt)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    live_warp_rows = torch.zeros((), dtype=torch.int64, device=dev)
    by_warp = warp_pixels(ts, dev) if count_warp_rows else None
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
            if count_warp_rows:
                live_warp_rows += ok[:, by_warp].view(T, -1, 32).any(-1).sum()
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
    if count_warp_rows:
        warp_rows = int(kstart[:, by_warp].view(T, -1, 32).amax(-1).sum())
        return gpairs, warp_rows, int(live_warp_rows)
    return gpairs


def _check_bwd_inputs(device, T: int, C: int, g_out, g_alpha, logt, ncomp, ts: int):
    P = ts * ts
    for name, x, shape in (("g_out", g_out, (T, P, C)), ("g_alpha", g_alpha, (T, P)),
                           ("logt", logt, (T, P)), ("ncomp", ncomp, (T, P))):
        if x.device != device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 on {device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} {tuple(x.shape)}: want {shape}")


def _check_bwd_tile(ts: int) -> None:
    """K2 / K4 / K6 run two CTAs a tile, each whole 8 x 4 pixel blocks of
    one thread a pixel."""
    if ts * ts > 1024 or ts % 8:
        raise ValueError(f"tile_size {ts}: the backward kernels need ts*ts <= 1024 and ts a "
                         "multiple of 8")


def _launch_bwd_kernel(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp,
                       tw: int, ts: int, two_tile: bool = False):
    """K2, or K6 with `two_tile`, at any C <= MAX_CHANNELS: one launch a
    channel piece (`bwd_pieces`)."""
    _check_bwd_tile(ts)
    return bwd_pieces(lambda a, b, g, ga: _kernel_bwd(pair_gidx, starts, counts, a, b, g, ga, logt,
                                                      ncomp, tw, ts, two_tile),
                      attrs, bg, g_out, g_alpha)


def _kernel_bwd(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp, tw: int,
                ts: int, two_tile: bool):
    """The launch of K2 / K6 at an instantiated C."""
    C = attrs.shape[1] - 6
    if two_tile:
        _require_clusters("bwd2", C, ts)

    T = starts.shape[0]
    gpairs = torch.zeros(pair_gidx.shape[0], 6 + C, dtype=torch.float32, device=attrs.device)
    if T == 0:
        return gpairs
    name = "ggt_composite_pairs_bwd2" if two_tile else "ggt_composite_pairs_bwd"
    launch("composite_pairs_bwd", name,
           [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
           pair_gidx.data_ptr(), starts.data_ptr(), counts.data_ptr(), attrs.data_ptr(),
           bg.data_ptr(), g_out.data_ptr(), g_alpha.data_ptr(), logt.data_ptr(),
           ncomp.data_ptr(), T, tw, ts, C, gpairs.data_ptr(), device=attrs.device)
    return gpairs


def _pairs_bwd_unchecked(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp,
                         tw: int, ts: int, two_tile: bool):
    """`composite_pairs_bwd` past its input checks, whose reduction is a host
    sync: the autograd backward's path, after a forward that checked the
    same stream."""
    args = (pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp, tw, ts)
    if use_kernel(attrs.device, "composite_pairs_bwd"):
        return _launch_bwd_kernel(*args, two_tile=two_tile)
    return composite_pairs_bwd_plain(*args)


def composite_pairs_bwd(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp,
                        tw: int, ts: int, two_tile: bool = False):
    """K2's per-stream-row gradients gpairs (B, 6 + C): the CUDA kernel for
    CUDA tensors (K6 with `two_tile`), the plain version for CPU tensors.
    Arguments as in `composite_pairs_bwd_plain`."""
    use_kernel(attrs.device, "composite_pairs_bwd")  # before the checks' sync
    _check_inputs(pair_gidx, starts, counts, attrs, bg)
    _check_bwd_inputs(attrs.device, starts.shape[0], attrs.shape[1] - 6, g_out, g_alpha, logt,
                      ncomp, ts)
    return _pairs_bwd_unchecked(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp,
                                tw, ts, two_tile)


class _CompositePairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pair_gidx, starts, counts, xys, conics, opacities, colors, bg, tw, ts):
        attrs = pack_attrs(xys, conics, opacities, colors)
        bg = bg.float().contiguous()
        ctx.two_tile = tiles_per_instance(TP) == 2
        out, alpha, logt, ncomp = composite_pairs_fwd(pair_gidx, starts, counts, attrs, bg, tw, ts,
                                                      two_tile=ctx.two_tile)
        ctx.save_for_backward(pair_gidx, starts, counts, attrs, bg, logt, ncomp)
        ctx.tiles = (tw, ts)
        return out, alpha

    @staticmethod
    def backward(ctx, g_out, g_alpha):
        pair_gidx, starts, counts, attrs, bg, logt, ncomp = ctx.saved_tensors
        with PROFILER.section("composite_bwd"):
            g_out, g_alpha = g_out.float().contiguous(), g_alpha.float().contiguous()
            # the forward already checked the stream against the table: no second host sync
            _check_bwd_inputs(attrs.device, starts.shape[0], attrs.shape[1] - 6, g_out, g_alpha,
                              logt, ncomp, ctx.tiles[1])
            gpairs = _pairs_bwd_unchecked(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha,
                                          logt, ncomp, *ctx.tiles, two_tile=ctx.two_tile)
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
    check_channels(tables.shape[2] - 6)
    # the kernels read rows [0, counts[t]) of tile t without bounds checks: one sync
    if counts.numel() and bool((counts < 0).any() | (counts > tables.shape[1]).any()):
        raise ValueError(f"counts must lie in [0, {tables.shape[1]}] (the table's K)")


def _launch_table_fwd(counts, tables, bg, tw: int, ts: int):
    """K3 at any C <= MAX_CHANNELS: one launch a channel piece (`fwd_pieces`)."""
    if ts * ts > 1024:
        raise ValueError(f"tile_size {ts}: one thread per pixel needs ts*ts <= 1024")
    out, weights = fwd_pieces(lambda t, b: _kernel_table_fwd(counts, t, b, tw, ts),
                              TABLE_FWD_CHANNELS, tables, bg)
    return (out,) + weights[0]


def _kernel_table_fwd(counts, tables, bg, tw: int, ts: int):
    """The launch of K3 at an instantiated C."""
    T, kt, a = tables.shape
    C = a - 6
    P = ts * ts
    out = torch.empty(T, P, C, dtype=torch.float32, device=tables.device)
    alpha, logt, ncomp = (torch.empty(T, P, dtype=torch.float32, device=tables.device)
                          for _ in range(3))
    if T == 0:
        return out, alpha, logt, ncomp
    launch("composite_pairs_fwd", "ggt_composite_tables_fwd",
           [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4,
           counts.data_ptr(), tables.data_ptr(), bg.data_ptr(), T, kt, tw, ts, C,
           out.data_ptr(), alpha.data_ptr(), logt.data_ptr(), ncomp.data_ptr(),
           device=tables.device)
    return out, alpha, logt, ncomp


def composite_tables_fwd(counts, tables, bg, tw: int, ts: int):
    """K3's four outputs (out (T, P, C), alpha, logt, ncomp (T, P)): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Arguments as in `composite_tables_fwd_plain`."""
    kernel = use_kernel(tables.device, "composite_tables_fwd")
    _check_table_inputs(counts, tables, bg)
    if kernel:
        return _launch_table_fwd(counts, tables, bg, tw, ts)
    return composite_tables_fwd_plain(counts, tables, bg, tw, ts)


def _launch_table_bwd(counts, tables, bg, g_out, g_alpha, logt, ncomp, tw: int, ts: int):
    """K4 at any C <= MAX_CHANNELS: one launch a channel piece (`bwd_pieces`)."""
    _check_bwd_tile(ts)
    return bwd_pieces(lambda t, b, g, ga: _kernel_table_bwd(counts, t, b, g, ga, logt, ncomp, tw,
                                                            ts),
                      tables, bg, g_out, g_alpha)


def _kernel_table_bwd(counts, tables, bg, g_out, g_alpha, logt, ncomp, tw: int, ts: int):
    """The launch of K4 at an instantiated C."""
    T, kt, a = tables.shape
    C = a - 6
    gattr = torch.zeros_like(tables)
    if T == 0:
        return gattr
    launch("composite_pairs_bwd", "ggt_composite_tables_bwd",
           [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
           counts.data_ptr(), tables.data_ptr(), bg.data_ptr(), g_out.data_ptr(),
           g_alpha.data_ptr(), logt.data_ptr(), ncomp.data_ptr(), T, kt, tw, ts, C,
           gattr.data_ptr(), device=tables.device)
    return gattr


def _tables_bwd_unchecked(counts, tables, bg, g_out, g_alpha, logt, ncomp, tw: int, ts: int):
    """`composite_tables_bwd` past its input checks, whose reduction is a
    host sync: the autograd backward's path, after a forward that checked
    the same counts."""
    args = (counts, tables, bg, g_out, g_alpha, logt, ncomp, tw, ts)
    if use_kernel(tables.device, "composite_tables_bwd"):
        return _launch_table_bwd(*args)
    return composite_tables_bwd_plain(*args)


def composite_tables_bwd(counts, tables, bg, g_out, g_alpha, logt, ncomp, tw: int, ts: int):
    """K4's per-(tile, slot) gradients gattr (T, Kt, 6 + C): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. g_out (T, P, C),
    g_alpha and K3's logt and ncomp (T, P)."""
    use_kernel(tables.device, "composite_tables_bwd")  # before the checks' sync
    _check_table_inputs(counts, tables, bg)
    _check_bwd_inputs(tables.device, tables.shape[0], tables.shape[2] - 6, g_out, g_alpha, logt,
                      ncomp, ts)
    return _tables_bwd_unchecked(counts, tables, bg, g_out, g_alpha, logt, ncomp, tw, ts)


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
        with PROFILER.section("composite_bwd"):
            g_out, g_alpha = g_out.float().contiguous(), g_alpha.float().contiguous()
            # the forward already checked counts against the table: no second host sync
            _check_bwd_inputs(tables.device, tables.shape[0], tables.shape[2] - 6, g_out,
                              g_alpha, logt, ncomp, ctx.tiles[1])
            gattr = _tables_bwd_unchecked(counts, tables, bg, g_out, g_alpha, logt, ncomp,
                                          *ctx.tiles)
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
