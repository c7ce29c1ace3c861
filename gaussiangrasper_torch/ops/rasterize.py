"""Tile-based rasterization of projected 2D Gaussians (counterpart of
the JAX package's ops/rasterize.py, Pallas backend).

1. binning: each Gaussian emits its covered tile rectangle (capped at
   `max_tiles_per_gaussian`), with pairs provably below the 1/255 alpha
   cutoff pruned; ONE stable sort over (tile id, camera depth) with the
   Gaussian index as payload yields depth-ordered per-tile segments of one
   pair stream. Ties keep index order (stable sort), as the JAX package's
   two-key `lax.sort` does. From the sorted stream `bin_gaussians` keeps
   the pair stream itself (`keep_pairs`) and / or a (T, K) table of each
   tile's first K entries (`build_table`).
2. compositing: `rasterize_cuda.composite_pair_stream` walks each tile's
   segment of the stream front to back (kernels K1 / K2);
   `rasterize_cuda.composite_binned` walks the rows of a (T, K) table
   (kernels K3 / K4). Each runs its hand-written kernel for CUDA tensors
   and its plain PyTorch version for CPU tensors.

Semantics shared with the CUDA reference rasterizer:
- alpha = min(0.999, opac * exp(-sigma)); skipped if sigma < 0 or
  alpha < 1/255.
- an entry is composited iff the running sum of log(1 - alpha) through it
  stays above log(1e-4).
- the background is blended with the terminal transmittance.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from gaussiangrasper_torch.ops.projection import ProjectedGaussians, project_gaussians
from gaussiangrasper_torch.utils.profiler import PROFILER

ALPHA_CLAMP = 0.999
ALPHA_CUTOFF = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4
_LOG_EPS = -9.2103403719761836  # log(TRANSMITTANCE_EPS)


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
"""Safety margin (in sigma units) for the alpha-cutoff tile pruning: the
lower bound d^2/(2*lambda_max) comes from cov2d while the composite
evaluates sigma from the conic; the margin absorbs their rounding skew."""


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
    with PROFILER.section("bin"):
        return _bin(proj, width, height, config, opacities, build_table, keep_pairs)


def _bin(proj: ProjectedGaussians, width: int, height: int, config: RasterizeConfig,
         opacities: Optional[torch.Tensor], build_table: bool, keep_pairs: bool) -> TileBins:
    ts = config.tile_size
    tw, th = tile_grid(width, height, ts)
    T = tw * th
    n = proj.xys.shape[0]
    K = min(config.max_gaussians_per_tile, n)
    MT = tiles_cap(config, T)

    keys_tile, keys_depth, row_counts, span = enumerate_pairs(
        proj, width, height, config, opacities
    )
    if PROFILER.on():  # the keys the sort takes, and the pairs kept (summed on the device)
        PROFILER.count("bin/pairs_sorted", n * MT)
        PROFILER.count("bin/pairs_kept", row_counts.sum())
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


def composite_weights(alpha: torch.Tensor, dim: int = -2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form front-to-back blending weights along `dim`:
    w_k = alpha_k * prod_{j<k}(1 - alpha_j), cut once transmittance would
    drop to <= 1e-4. Returns (weights, terminal transmittance)."""
    log_t = torch.log1p(-alpha)
    cum_incl = torch.cumsum(log_t, dim=dim)
    composite = torch.exp(cum_incl) > TRANSMITTANCE_EPS
    t_before = torch.exp(cum_incl - log_t)
    zero = torch.zeros((), dtype=alpha.dtype, device=alpha.device)
    weights = torch.where(composite, alpha * t_before, zero)
    t_final = torch.exp(torch.where(composite, log_t, zero).sum(dim=dim))
    return weights, t_final


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
    alpha (H, W), bins, and tiles (T, P, C), the pre-assembly view.

    Routed as the JAX package's Pallas backend routes: bins with a pair
    stream (and `bins=None`, which bins the stream alone) go to
    `composite_pair_stream` (K1 / K2); prebuilt table bins (`tile_gidx`,
    no stream) go to `composite_binned` (K3 / K4)."""
    from gaussiangrasper_torch.ops import rasterize_cuda

    ts = config.tile_size
    tw, th = tile_grid(width, height, ts)
    C = colors.shape[-1]
    if bins is None:
        bins = bin_gaussians(proj, width, height, config, opacities=opacities,
                             build_table=False, keep_pairs=True)
    with PROFILER.section("composite"):
        if bins.pair_gidx is not None:
            K = min(config.max_gaussians_per_tile, proj.xys.shape[0])
            out, alpha = rasterize_cuda.composite_pair_stream(
                bins.pair_gidx, bins.pair_starts, bins.tile_count,
                proj.xys, proj.conics, opacities, colors, background, tw, ts, k_cap=K,
            )
        else:
            out, alpha = rasterize_cuda.composite_binned(
                bins.tile_gidx, bins.tile_count, proj.xys, proj.conics, opacities, colors,
                background, tw, ts,
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


def rasterize(
    means, scales, quats, opacities, colors, viewmat, fx, fy, cx, cy,
    width: int, height: int,
    background: Optional[torch.Tensor] = None,
    config: RasterizeConfig = RasterizeConfig(),
    mask: Optional[torch.Tensor] = None,
):
    """Project + bin + composite in one call (the simple API)."""
    proj = project_gaussians(means, scales, quats, viewmat, fx, fy, cx, cy,
                             width, height, mask=mask)
    if background is None:
        background = torch.zeros(colors.shape[-1], dtype=colors.dtype, device=colors.device)
    out = rasterize_projected(proj, colors, opacities, background, width, height, config)
    out["proj"] = proj
    return out
