"""Binning and compositing of the splat reference: the pair enumeration
and one stable sort of ops/rasterize.py, and the plain front-to-back
walk (forward) and reverse walk (backward) of ops/rasterize_cuda.py, tied
together by an autograd Function, with no kernel behind either.

Frozen copies from gaussiangrasper_torch at commit d90391f: ops/rasterize.py
(RasterizeConfig, TileBins, tile_grid, tiles_cap, enumerate_pairs,
bin_gaussians, rasterize_projected) and ops/rasterize_cuda.py
(composite_pairs_fwd_plain, composite_pairs_bwd_plain, pack_attrs,
stream_bounds, _CompositePairs). Changed: the forward walk counts each
pixel's visits up to its last composited pair and its live visits
(`walk_counts`), the kernels' warp-row counts are left out, the backward's
full_f32 block is gone (the caller sets the precision: `precision`), and
the autograd Function calls the plain versions only.
Plain PyTorch; imports nothing of gaussiangrasper_torch or JAX.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from .geometry import ProjectedGaussians

ALPHA_CLAMP = 0.999
ALPHA_CUTOFF = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4
_LOG_EPS = -9.2103403719761836  # log(TRANSMITTANCE_EPS)
WALK_CHUNK = 128

# --- from gaussiangrasper_torch/ops/rasterize.py ---

@dataclasses.dataclass(frozen=True)
class RasterizeConfig:
    """Same fields and defaults as the JAX package's RasterizeConfig, so a
    `config.json` written by a JAX run loads. `tile_chunk`, `backend` and
    `kernel_compute` tune or choose TPU paths and are not read here: the
    port composites in the CUDA kernel for CUDA tensors and in its plain
    version for CPU tensors, always in float32."""

    tile_size: int = 32
    max_gaussians_per_tile: int = 2048  # K: per-tile walk clamp
    max_tiles_per_gaussian: int = 16    # MT; 0 = the whole grid
    tile_chunk: int = 8
    backend: str = "auto"
    pair_budget_per_tile: int = 1536    # B = T * this (0 = use K)
    kernel_compute: str = "auto"


class TileBins(NamedTuple):
    tile_gidx: Optional[torch.Tensor]  # (T, K) int32 front-most K per tile, -1 pad
    tile_count: torch.Tensor     # (T,) int32 entries per tile (pre-clamp)
    num_tiles_hit: torch.Tensor  # (N,) int32 tiles kept per Gaussian
    overflow: torch.Tensor       # () int32 entries dropped by the K clamp
    dropped_tiles: torch.Tensor  # () int32 tiles dropped by the MT cap
    pair_gidx: Optional[torch.Tensor] = None   # (B,) int32 sorted payload
    pair_starts: Optional[torch.Tensor] = None  # (T,) int32 segment starts
    pair_overflow: Optional[torch.Tensor] = None  # () int32 pairs beyond B


def tile_grid(width: int, height: int, tile_size: int) -> Tuple[int, int]:
    return -(-width // tile_size), -(-height // tile_size)


def tiles_cap(config: RasterizeConfig, num_tiles: int) -> int:
    """Resolved per-Gaussian covered-tile cap MT (<= 0 means the grid)."""
    if config.max_tiles_per_gaussian <= 0:
        return num_tiles
    return min(config.max_tiles_per_gaussian, num_tiles)


_PRUNE_MARGIN = 1e-4


def enumerate_pairs(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    config: RasterizeConfig,
    opacities: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Candidate (gaussian, covered-tile) pairs on an (N, MT) grid.

    Returns keys_tile (N*MT,) int64 with sentinel T for pruned/invalid
    pairs, keys_depth (N*MT,) f32, row_counts (N,) kept pairs per
    Gaussian and span (N,) pre-cap covered-tile counts. With `opacities`,
    pairs whose alpha is below 1/255 everywhere in the tile are pruned:
    sigma >= d^2 / (2*lmax), so d^2 > 2*lmax*(log(255*opac) + margin)
    means the pair contributes exactly zero."""
    ts = config.tile_size
    tw, th = tile_grid(width, height, ts)
    T = tw * th
    MT = tiles_cap(config, T)
    xys = proj.xys.detach()
    x, y = xys[:, 0], xys[:, 1]
    r = proj.radii.detach()
    alive = r > 0.0

    r_cut2 = None
    if opacities is not None:
        opac = opacities.detach()
        cov = proj.cov2d.detach()
        a_, b_, c_ = cov[:, 0], cov[:, 1], cov[:, 2]
        det = a_ * c_ - b_ * b_
        b_half = 0.5 * (a_ + c_)
        lmax = b_half + torch.sqrt(torch.clamp(b_half * b_half - det, min=0.1))
        log_term = torch.log(torch.clamp(255.0 * opac, min=1e-12)) + _PRUNE_MARGIN
        r_cut2 = 2.0 * lmax * torch.clamp(log_term, min=0.0)
        r = torch.minimum(r, torch.ceil(torch.sqrt(r_cut2)))

    def tile_clip(v, hi):
        return torch.clamp(v, 0, hi).to(torch.int64)

    x0 = tile_clip(torch.floor((x - r) / ts), tw)
    y0 = tile_clip(torch.floor((y - r) / ts), th)
    x1 = tile_clip(torch.floor((x + r) / ts) + 1, tw)
    y1 = tile_clip(torch.floor((y + r) / ts) + 1, th)
    w_span = torch.clamp(x1 - x0, min=0)
    h_span = torch.clamp(y1 - y0, min=0)
    span = torch.where(alive, w_span * h_span, torch.zeros_like(w_span))

    j = torch.arange(MT, device=xys.device)
    w_safe = torch.clamp(w_span, min=1)[:, None]
    tx = x0[:, None] + j[None, :] % w_safe
    ty = y0[:, None] + j[None, :] // w_safe
    keep = j[None, :] < torch.clamp(span, max=MT)[:, None]
    if r_cut2 is not None:
        # nearest pixel centre of tile (tx, ty) to the splat centre
        px0 = (tx * ts).to(x.dtype)
        py0 = (ty * ts).to(y.dtype)
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        ddx = torch.maximum(torch.maximum(px0 - x[:, None], x[:, None] - (px0 + (ts - 1))), zero)
        ddy = torch.maximum(torch.maximum(py0 - y[:, None], y[:, None] - (py0 + (ts - 1))), zero)
        keep = keep & (ddx * ddx + ddy * ddy <= r_cut2[:, None])

    row_counts = keep.sum(dim=1, dtype=torch.int32)
    keys_tile = torch.where(keep, ty * tw + tx, torch.full_like(tx, T)).reshape(-1)
    keys_depth = proj.depths.detach()[:, None].expand(-1, MT).reshape(-1)
    return keys_tile, keys_depth, row_counts, span


def bin_gaussians(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    config: RasterizeConfig,
    opacities: Optional[torch.Tensor] = None,
    build_table: bool = True,
    keep_pairs: bool = False,
) -> TileBins:
    """Depth-ordered per-tile Gaussian lists, with the JAX package's
    keywords and defaults: `build_table` fills `tile_gidx` (T, K), the
    first K (front-most) entries of each tile segment, -1 past the
    segment; `keep_pairs` keeps the sorted stream itself (`pair_gidx`, its
    budget B = T * pair_budget_per_tile and `pair_overflow`).

    The two-key stable sort becomes ONE stable sort of an int64 key
    `tile << 32 | float32 bits of depth`: live depths are > 0.01 and culled
    rows carry the sentinel tile T with depth +0.0, so the bit order of the
    non-negative depths is their float order, and stability keeps index
    order on ties."""
    ts = config.tile_size
    tw, th = tile_grid(width, height, ts)
    T = tw * th
    n = proj.xys.shape[0]
    K = min(config.max_gaussians_per_tile, n)
    MT = tiles_cap(config, T)

    keys_tile, keys_depth, row_counts, span = enumerate_pairs(
        proj, width, height, config, opacities
    )
    depth_bits = keys_depth.contiguous().view(torch.int32).to(torch.int64)
    _, perm = torch.sort((keys_tile << 32) | depth_bits, stable=True)
    sorted_tile = keys_tile[perm]
    sorted_gidx = torch.div(perm, MT, rounding_mode="floor").to(torch.int32)
    boundaries = torch.searchsorted(
        sorted_tile, torch.arange(T + 1, dtype=torch.int64, device=perm.device)
    )
    starts = boundaries[:-1]
    tile_count = boundaries[1:] - starts
    n_pairs = n * MT
    i32 = torch.int32

    tile_gidx = None
    if build_table:
        k = torch.arange(K, device=perm.device)
        pos2 = torch.clamp(starts[:, None] + k[None, :], 0, max(n_pairs - 1, 0))
        in_seg = k[None, :] < tile_count[:, None]
        tile_gidx = torch.where(in_seg, sorted_gidx[pos2], -1).to(i32)

    pairs = {}
    if keep_pairs:
        pb = config.pair_budget_per_tile or K
        B = min(T * pb, n_pairs)
        clamped = torch.clamp(tile_count, max=K)
        walk_end = torch.clamp(starts + clamped, max=B)
        pair_overflow = (clamped - torch.clamp(walk_end - torch.clamp(starts, max=B), min=0)).sum()
        pairs = dict(pair_gidx=sorted_gidx[:B], pair_starts=starts.to(i32),
                     pair_overflow=pair_overflow.to(i32))
    return TileBins(
        tile_gidx=tile_gidx,
        tile_count=tile_count.to(i32),
        num_tiles_hit=row_counts,
        overflow=torch.clamp(tile_count - K, min=0).sum().to(i32),
        dropped_tiles=torch.clamp(span - MT, min=0).sum().to(i32),
        **pairs,
    )


def rasterize_projected(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    background: torch.Tensor,
    width: int,
    height: int,
    config: RasterizeConfig = RasterizeConfig(),
    bins: Optional[TileBins] = None,
):
    """Rasterize projected Gaussians: colors (N, C), opacities (N,)
    post-sigmoid, background (C,). Returns a dict with image (H, W, C),
    alpha (H, W), bins, and tiles (T, P, C), the pre-assembly view. The
    pair stream alone, walked by the plain compositor."""
    ts = config.tile_size
    tw, th = tile_grid(width, height, ts)
    C = colors.shape[-1]
    if bins is None:
        bins = bin_gaussians(proj, width, height, config, opacities=opacities,
                             build_table=False, keep_pairs=True)
    K = min(config.max_gaussians_per_tile, proj.xys.shape[0])
    out, alpha = composite_pair_stream(
        bins.pair_gidx, bins.pair_starts, bins.tile_count,
        proj.xys, proj.conics, opacities, colors, background, tw, ts, k_cap=K,
    )
    # (T, P, C) -> (th, tw, ts, ts, C) -> (H, W, C), cropping tile padding
    image = out.reshape(th, tw, ts, ts, C).transpose(1, 2).reshape(th * ts, tw * ts, C)
    alpha_image = alpha.reshape(th, tw, ts, ts).transpose(1, 2).reshape(th * ts, tw * ts)
    return {
        "image": image[:height, :width],
        "alpha": alpha_image[:height, :width],
        "bins": bins,
        "tiles": out,
    }


# --- from gaussiangrasper_torch/ops/rasterize_cuda.py ---


def _pixel_coords(num_tiles: int, tw: int, ts: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, P) integer pixel-centre coordinates of every tile's pixels."""
    t = torch.arange(num_tiles, device=device)[:, None]
    lin = torch.arange(ts * ts, device=device)[None, :]
    px = ((t % tw) * ts + lin % ts).to(torch.float32)
    py = ((t // tw) * ts + lin // ts).to(torch.float32)
    return px, py


def composite_pairs_fwd_plain(pair_gidx, starts, counts, attrs, bg, tw: int, ts: int,
                              walk_counts: bool = False):
    """The forward walk, one stream row at a time, vectorized over every
    tile and pixel.

    pair_gidx (B,) int32; starts, counts (T,) int32 with counts <= B - starts;
    attrs (N, 6 + C) rows xy | conic (a, b, c) | opacity | colour; bg (C,).
    Returns out (T, P, C), alpha, logt, ncomp (T, P) float32, plus, with
    `walk_counts`, (visits, live) (T, P) int64: the pairs each pixel walks up
    to and including the last one it composites before the transmittance
    cut, and those of them it composites (alpha >= 1/255)."""
    T = starts.shape[0]
    C = attrs.shape[1] - 6
    dev = attrs.device
    px, py = _pixel_coords(T, tw, ts, dev)
    acc = torch.zeros(T, ts * ts, C, dtype=torch.float32, device=dev)
    cum_all = torch.zeros(T, ts * ts, dtype=torch.float32, device=dev)
    logt = torch.zeros_like(cum_all)
    cut = torch.full(cum_all.shape, -1, dtype=torch.int64, device=dev)
    live = torch.zeros(cum_all.shape, dtype=torch.int64, device=dev)
    last = torch.full(cum_all.shape, -1, dtype=torch.int64, device=dev)
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
        acc = acc + torch.einsum("tp,tc->tpc", w, row[:, 6:])
        logt = torch.where(comp, logt + lt, logt)
        cum_all = torch.where(comp, cum, cum_all)
        cut = torch.where(crossed, k, cut)
        live = live + comp.to(torch.int64)
        if walk_counts:
            last = torch.where(comp, k, last)
    t_final = torch.exp(logt)
    out = acc + t_final[..., None] * bg
    walk_len = (counts64 + WALK_CHUNK - 1) // WALK_CHUNK * WALK_CHUNK
    ncomp = torch.where(cut >= 0, cut, walk_len[:, None]).to(torch.float32)
    res = (out, 1.0 - t_final, logt, ncomp)
    if walk_counts:
        res = res + (last + 1, live)
    return res


def composite_pairs_bwd_plain(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha, logt, ncomp,
                              tw: int, ts: int):
    """The reverse walk, one stream row at a time from the last composited
    row down to 0, vectorized over every tile and pixel.

    Stream inputs as in `composite_pairs_fwd_plain`; g_out (T, P, C),
    g_alpha, and the forward's logt and ncomp (T, P). A pixel's walk covers
    rows k < min(ncomp, count). Returns gpairs (B, 6 + C): per stream row,
    dxy | dconic | dopacity | dcolour summed over the tile's pixels; rows no
    tile walks are zero."""
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


def pack_attrs(xys, conics, opacities, colors) -> torch.Tensor:
    """Per-Gaussian attribute rows (N, 6 + C): xy | conic | opacity | colour."""
    return torch.cat([xys, conics, opacities[:, None], colors], dim=1).float().contiguous()


def stream_bounds(pair_gidx, seg_starts, tile_count, k_cap: int):
    """Per-tile walk (starts, counts), int32: min(tile_count, k_cap,
    B - start) pairs from min(start, B)."""
    b = pair_gidx.shape[0]
    starts = torch.clamp(seg_starts, max=b)
    counts = torch.minimum(torch.clamp(tile_count, max=k_cap), torch.clamp(b - starts, min=0))
    return starts.to(torch.int32).contiguous(), counts.to(torch.int32).contiguous()


class _CompositePairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pair_gidx, starts, counts, xys, conics, opacities, colors, bg, tw, ts):
        attrs = pack_attrs(xys, conics, opacities, colors)
        bg = bg.float().contiguous()
        out, alpha, logt, ncomp = composite_pairs_fwd_plain(pair_gidx, starts, counts, attrs, bg,
                                                            tw, ts)
        ctx.save_for_backward(pair_gidx, starts, counts, attrs, bg, logt, ncomp)
        ctx.tiles = (tw, ts)
        return out, alpha

    @staticmethod
    def backward(ctx, g_out, g_alpha):
        pair_gidx, starts, counts, attrs, bg, logt, ncomp = ctx.saved_tensors
        g_out, g_alpha = g_out.float().contiguous(), g_alpha.float().contiguous()
        gpairs = composite_pairs_bwd_plain(pair_gidx, starts, counts, attrs, bg, g_out, g_alpha,
                                           logt, ncomp, *ctx.tiles)
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
