"""Tile-sharded compositing with a frustum-culled all-gather (counterpart
of the JAX package's parallel/tile_shard.py).

Each gauss rank holds a contiguous capacity shard and composites one
horizontal band of image tiles:

  1. (shard half) compact the shard's culled survivors (radii > 0), in
     order, into a `gather_budget`-row attribute table; in "merge" mode
     also enumerate the table's (tile, depth) pairs and sort them, stably,
     on the shard alone;
  2. one all-gather moves the tables (`comm.all_gather_rows`: its
     backward is the reduce-scatter sum of the bands' gradients) and one
     the sorted streams;
  3. (band half) cut the band's slice out of every source stream, merge
     the slices by (tile, depth, global index), find each tile's segment
     by searchsorted and composite the band through `rasterize_projected`
     with those pair bins: K1 / K2 (K5 / K6 under GGT_TP=2). "replicated"
     mode bins the gathered table again in every band instead;
  4. the bands stack back along the image rows (`comm.all_gather_bands`).

The halves are plain functions on tensors, so `composite_tile_split` runs
a D-way split in one process, with `torch.cat` in place of the
all-gathers: the same code path on one card.

The geometry is the JAX package's, or the bands would not stitch: th_pad =
ceil(th / d) * d tile rows, bands of hb = th_pad / d * tile_size pixel rows,
band b's rows shifted up by b * hb, tile ids band-relative with the
sentinel T past the last tile, global index = compaction rank + shard * v,
the image cut back to `height`.

Exactness: shards are contiguous and compaction keeps their order, so a
tie in (tile, depth) among the merged pairs is broken by the global index
as the single-device stable sort breaks it by the Gaussian index. Every
drop is counted, never silent: rows past the gather budget in
`gather_overflow`, pairs past a source's band budget in `merge_overflow`,
pairs past K in `overflow`, tiles past the per-Gaussian cap in
`dropped_tiles`.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gaussiangrasper_torch.ops.projection import ProjectedGaussians
from gaussiangrasper_torch.ops.rasterize import (
    RasterizeConfig,
    TileBins,
    enumerate_pairs,
    rasterize_projected,
    tile_grid,
    tiles_cap,
)


class ShardedBins(NamedTuple):
    """The sharded path's binning stats (the per-band bins stay local)."""

    overflow: torch.Tensor         # () int32, max over bands of K-cap overflow
    dropped_tiles: torch.Tensor    # () int32, summed
    gathered_rows: torch.Tensor    # () int32, culled rows gathered
    gather_overflow: torch.Tensor  # () int32, rows dropped by gather_budget
    gathered_bytes: torch.Tensor   # () int32, bytes each rank received
    merge_overflow: Optional[torch.Tensor] = None  # () int32, in-band pairs
    # dropped by the per-source band_pair_budget (merge mode)


def derive_gather_budget(alive, d: int, *, margin: float = 1.25, quantum: int = 128) -> int:
    """Per-rank gather budget from an alive mask (numpy or torch): the most
    alive rows in any of the d contiguous shards (a freshly seeded field
    packs them into a capacity prefix), times `margin`, rounded up to
    `quantum` rows, at least one quantum and at most the shard size."""
    mask = alive.detach().cpu().numpy() if isinstance(alive, torch.Tensor) else np.asarray(alive)
    cap_per_dev = mask.shape[0] // max(d, 1)
    worst = int(mask[: cap_per_dev * d].reshape(d, cap_per_dev).sum(1).max())
    budget = -(-int(worst * margin) // quantum) * quantum
    return max(quantum, min(budget, cap_per_dev))


@dataclasses.dataclass(frozen=True)
class BandGeometry:
    d: int        # shards = bands
    v: int        # table rows a shard (the gather budget)
    tw: int       # tile columns
    hb: int       # band height in pixels
    T: int        # tiles of the image (the sentinel tile id)
    t_band: int   # tiles a band
    mt: int       # covered-tile cap a Gaussian
    bpb: int      # pairs a source stream may put into one band
    a_dim: int    # table row: xy, depth, conic, cov2d, radius, opacity, colour


def band_geometry(shard_rows: int, d: int, channels: int, width: int, height: int,
                  config: RasterizeConfig, gather_budget: Optional[int] = None,
                  band_pair_budget: Optional[int] = None) -> BandGeometry:
    """`band_pair_budget` None: 1.25x the balanced share of one source's
    pairs in one band, rounded up to 128."""
    v = min(gather_budget or shard_rows, shard_rows)
    ts = config.tile_size
    tw, th = tile_grid(width, height, ts)
    th_pad = -(-th // d) * d
    T = tw * th
    mt = tiles_cap(config, T)
    if band_pair_budget is None:
        band_pair_budget = max(128, -(-(5 * v * mt) // (4 * d * 128)) * 128)
    return BandGeometry(d=d, v=v, tw=tw, hb=(th_pad // d) * ts, T=T, t_band=(th_pad // d) * tw,
                        mt=mt, bpb=band_pair_budget, a_dim=11 + channels)


def _depth_bits(depth: torch.Tensor) -> torch.Tensor:
    """float32 bits as int64; their order is the float order for the
    non-negative depths the streams carry (live depths > 0.01, empty rows
    +0.0)."""
    return depth.contiguous().view(torch.int32).to(torch.int64)


class ShardPart(NamedTuple):
    table: torch.Tensor             # (v, a_dim) compacted survivors, differentiable
    stream: Optional[torch.Tensor]  # (3, v * mt) int64 sorted tile | depth bits | row
    stats: torch.Tensor             # (3,) int64 survivors, survivors past v, dropped tiles


def shard_part(proj: ProjectedGaussians, colors, opacities, geo: BandGeometry, width: int,
               height: int, config: RasterizeConfig, bin_mode: str = "merge") -> ShardPart:
    """A shard's half before the all-gather: the order-preserving
    compaction and, in merge mode, the shard's stably sorted pair stream."""
    v = geo.v
    vis = proj.radii > 0.0
    attrs = torch.cat([proj.xys, proj.depths[:, None], proj.conics, proj.cov2d,
                       proj.radii[:, None], opacities[:, None], colors], dim=-1)
    csum = torch.cumsum(vis.to(torch.int64), 0)
    count = csum[-1]
    # table row j is the shard's j-th survivor: the first index whose
    # running count reaches j + 1. Rows past the survivors read row j and
    # are zeroed: distinct sources keep the gather's backward free of long
    # runs of one index (v <= the shard's rows)
    j = torch.arange(v, device=attrs.device)
    live = j < count
    src = torch.where(live, torch.searchsorted(csum, j + 1), j)
    table = torch.where(live[:, None], attrs[src], torch.zeros((), dtype=attrs.dtype,
                                                               device=attrs.device))
    stream = None
    dropped = torch.zeros((), dtype=torch.int64, device=attrs.device)
    if bin_mode == "merge":
        t = table.detach()
        local = ProjectedGaussians(xys=t[:, 0:2], depths=t[:, 2], conics=t[:, 3:6],
                                   radii=t[:, 9], cov2d=t[:, 6:9])
        kt, kd, _, span = enumerate_pairs(local, width, height, config, t[:, 10])
        bits = _depth_bits(kd)
        _, perm = torch.sort((kt << 32) | bits, stable=True)
        stream = torch.stack([kt[perm], bits[perm], torch.div(perm, geo.mt, rounding_mode="floor")])
        dropped = torch.clamp(span - geo.mt, min=0).sum()
    elif bin_mode != "replicated":
        raise ValueError(f"bin_mode {bin_mode!r}: 'merge' or 'replicated'")
    stats = torch.stack([count, torch.clamp(count - v, min=0), dropped.to(torch.int64)])
    return ShardPart(table, stream, stats)


def merge_band_bins(streams: torch.Tensor, band: int, geo: BandGeometry, config: RasterizeConfig
                    ) -> Tuple[TileBins, int]:
    """Band `band`'s pair bins from the gathered sorted streams (d, 3, L):
    each source's in-band slice (its first `bpb` pairs; the rest are
    counted and dropped), merged by (tile, depth, global index). Returns
    the bins, band-relative, and the pairs past the budget.

    The merged stream holds the in-band pairs alone: the JAX package's
    keeps each source's whole `bpb` window at a static size, sentinels
    after the slice (d * bpb rows, 1.25x a balanced band's pairs times d),
    and parks them at T - lo, inside the last band's padding tile rows
    when ceil(th / d) * d > th, where its `overflow` counts them past K
    (ROADMAP.md, F8). One host read of the slices' bounds sizes it."""
    d, v, bpb = geo.d, geo.v, geo.bpb
    dev = streams.device
    lo = band * geo.t_band
    hi = min(lo + geo.t_band, geo.T)
    bounds = torch.searchsorted(streams[:, 0].contiguous(),
                                torch.tensor([[lo, hi]] * d, dtype=torch.int64, device=dev))
    parts, ovf = [], 0
    for s, (a, b) in enumerate(bounds.tolist()):
        tile, bit, row = streams[s, :, a: a + min(max(b - a, 0), bpb)]
        parts.append(torch.stack([tile, bit, row + s * v]))  # global index: shard * v + row
        ovf += max(b - a - bpb, 0)
    tiles, bits, rows = torch.cat(parts, dim=1)
    # sources in shard order, each sorted with ties in row order: a stable
    # sort on (tile, depth) breaks ties by the global index
    _, perm = torch.sort((tiles << 32) | bits, stable=True)
    boundaries = torch.searchsorted(tiles[perm] - lo, torch.arange(geo.t_band + 1, device=dev))
    starts = boundaries[:-1]
    counts = boundaries[1:] - starts
    k_cap = min(config.max_gaussians_per_tile, d * v)
    i32 = torch.int32
    zero = torch.zeros((), dtype=i32, device=dev)
    # every segment lies inside the merged stream, so the stream budget
    # clips nothing (pair_overflow 0): the band path's only pair clamp is
    # bpb, counted in merge_overflow
    bins = TileBins(tile_gidx=None, tile_count=counts.to(i32),
                    num_tiles_hit=torch.zeros(d * v, dtype=i32, device=dev),
                    overflow=torch.clamp(counts - k_cap, min=0).sum().to(i32), dropped_tiles=zero,
                    pair_gidx=rows[perm].to(i32), pair_starts=starts.to(i32), pair_overflow=zero)
    return bins, ovf


def band_part(tables: torch.Tensor, streams: Optional[torch.Tensor], band: int, background,
              geo: BandGeometry, width: int, config: RasterizeConfig
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A band's half after the all-gather: its (hb, W, C) image, (hb, W)
    alpha and stats (4,) int64: K overflow, dropped tiles, pairs past the
    band budget, stream rows of the band's tiles."""
    bins, merge_ovf = None, 0
    if streams is not None:
        bins, merge_ovf = merge_band_bins(streams, band, geo, config)
    y_off = float(band * geo.hb)
    proj = ProjectedGaussians(xys=tables[:, 0:2] - tables.new_tensor([0.0, y_off]),
                              depths=tables[:, 2], conics=tables[:, 3:6], radii=tables[:, 9],
                              cov2d=tables[:, 6:9])
    out = rasterize_projected(proj, tables[:, 11:], tables[:, 10], background, width, geo.hb,
                              config, bins=bins)
    b = out["bins"]
    stats = torch.stack([b.overflow.to(torch.int64), b.dropped_tiles.to(torch.int64),
                         torch.tensor(merge_ovf, device=tables.device),
                         b.tile_count.to(torch.int64).sum()])
    return out["image"], out["alpha"], stats


def _assemble(bands: torch.Tensor, shard_stats: torch.Tensor, band_stats: torch.Tensor,
              geo: BandGeometry, height: int, channels: int) -> dict:
    """The stitched (d * hb, W, C + 1) bands and the (d, 3) / (d, 4)
    stats -> rasterize_projected's dict with `ShardedBins`, plus each
    band's stream rows (`band_rows`)."""
    i32 = torch.int32
    rows = shard_stats[:, 0].sum()
    bins = ShardedBins(
        overflow=band_stats[:, 0].max().to(i32),
        dropped_tiles=(shard_stats[:, 2].sum() + band_stats[:, 1].sum()).to(i32),
        gathered_rows=rows.to(i32),
        gather_overflow=shard_stats[:, 1].sum().to(i32),
        gathered_bytes=(rows * (geo.a_dim * 4) * (geo.d - 1) // geo.d).to(i32),
        merge_overflow=band_stats[:, 2].sum().to(i32),
    )
    return {"image": bands[:height, :, :channels], "alpha": bands[:height, :, channels],
            "bins": bins, "band_rows": band_stats[:, 3]}


def _stitch_input(image, alpha) -> torch.Tensor:
    return torch.cat([image, alpha[..., None]], dim=-1)


def composite_tile_sharded(proj: ProjectedGaussians, colors, opacities, background, width: int,
                           height: int, config: RasterizeConfig = RasterizeConfig(), *, mesh,
                           axis: str = "gauss", gather_budget: Optional[int] = None,
                           bin_mode: str = "merge", band_pair_budget: Optional[int] = None) -> dict:
    """`rasterize_projected` over the `axis` ranks of `mesh`: the inputs
    are this rank's contiguous shard of the capacity (rank order), the
    image and alpha come back whole on every rank, with `ShardedBins`.

    gather_budget: table rows a rank (None: the shard size, exact for any
    input); bin_mode "merge" (bin once, distributed) or "replicated" (each
    band bins the gathered table); band_pair_budget: see `band_geometry`.
    """
    from gaussiangrasper_torch.parallel import comm

    group = mesh.groups[axis]
    d, band = mesh.shape[axis], mesh.coords[axis]
    c = colors.shape[-1]
    geo = band_geometry(proj.xys.shape[0], d, c, width, height, config, gather_budget,
                        band_pair_budget)
    part = shard_part(proj, colors, opacities, geo, width, height, config, bin_mode)
    tables = comm.all_gather_rows(part.table, group)
    streams = None
    if part.stream is not None:
        streams = comm.all_gather(part.stream[None], group)
    image, alpha, band_stats = band_part(tables, streams, band, background, geo, width, config)
    bands = comm.all_gather_bands(_stitch_input(image, alpha), group)
    stats = comm.all_gather(torch.cat([part.stats, band_stats])[None], group)
    return _assemble(bands, stats[:, :3], stats[:, 3:], geo, height, c)


def composite_tile_split(proj: ProjectedGaussians, colors, opacities, background, width: int,
                         height: int, config: RasterizeConfig = RasterizeConfig(), *, d: int,
                         gather_budget: Optional[int] = None, bin_mode: str = "merge",
                         band_pair_budget: Optional[int] = None) -> dict:
    """`composite_tile_sharded`'s D-way split in one process: both halves
    run for every shard and band, `torch.cat` in place of each all-gather
    (autograd then sums the bands' gradients of the shared table, as the
    reduce-scatter does). The inputs are the whole capacity."""
    n = proj.xys.shape[0]
    if n % d != 0:
        raise ValueError(f"capacity {n} not divisible by gauss={d}")
    nl = n // d
    c = colors.shape[-1]
    geo = band_geometry(nl, d, c, width, height, config, gather_budget, band_pair_budget)
    parts: List[ShardPart] = []
    for s in range(d):
        rows = slice(s * nl, (s + 1) * nl)
        shard = ProjectedGaussians(*(x[rows] for x in proj))
        parts.append(shard_part(shard, colors[rows], opacities[rows], geo, width, height, config,
                                bin_mode))
    tables = torch.cat([p.table for p in parts])
    streams = None if parts[0].stream is None else torch.stack([p.stream for p in parts])
    bands, band_stats = [], []
    for b in range(d):
        image, alpha, stats = band_part(tables, streams, b, background, geo, width, config)
        bands.append(_stitch_input(image, alpha))
        band_stats.append(stats)
    return _assemble(torch.cat(bands), torch.stack([p.stats for p in parts]),
                     torch.stack(band_stats), geo, height, c)


def tile_sharded_compositor(mesh, axis: str = "gauss", gather_budget: Optional[int] = None,
                            bin_mode: str = "merge", band_pair_budget: Optional[int] = None):
    """A `compositor` for models.model.render / train_loss: the
    rasterize_projected signature bound to the mesh."""
    return partial(composite_tile_sharded, mesh=mesh, axis=axis, gather_budget=gather_budget,
                   bin_mode=bin_mode, band_pair_budget=band_pair_budget)
