"""Occupancy grid for ray marching (counterpart of the JAX package's
models/occupancy.py).

A dense grid over the scene AABB holding an EMA of the largest density seen
in each cell. Sample counts stay fixed: samples in empty cells get zero
density (`masked_densities`) rather than being skipped."""

from __future__ import annotations

from typing import NamedTuple

import torch


class OccupancyGrid(NamedTuple):
    density: torch.Tensor  # (R, R, R) EMA of the max density per cell
    aabb: torch.Tensor     # (2, 3) scene bounds
    threshold: float

    @property
    def resolution(self) -> int:
        return self.density.shape[0]


def init_grid(aabb, resolution: int = 64, threshold: float = 0.01,
              device=None) -> OccupancyGrid:
    return OccupancyGrid(
        density=torch.zeros((resolution,) * 3, dtype=torch.float32, device=device),
        aabb=torch.as_tensor(aabb, dtype=torch.float32, device=device),
        threshold=threshold,
    )


def _cell_of(grid: OccupancyGrid, positions: torch.Tensor) -> torch.Tensor:
    """World positions (..., 3) -> integer cell indices (..., 3), clipped."""
    lo, hi = grid.aabb[0], grid.aabb[1]
    u = (positions - lo) / (hi - lo)
    idx = torch.floor(u * grid.resolution).to(torch.int64)
    return torch.clamp(idx, 0, grid.resolution - 1)


def _flat(grid: OccupancyGrid, idx: torch.Tensor) -> torch.Tensor:
    r = grid.resolution
    return (idx[..., 0] * r + idx[..., 1]) * r + idx[..., 2]


def update_grid(grid: OccupancyGrid, positions: torch.Tensor, densities: torch.Tensor,
                ema: float = 0.95) -> OccupancyGrid:
    """EMA decay, then a scatter-max of the observed densities (M,) at
    positions (M, 3)."""
    idx = _flat(grid, _cell_of(grid, positions))
    decayed = (grid.density * ema).reshape(-1)
    updated = decayed.scatter_reduce(0, idx, densities.to(decayed.dtype), "amax",
                                     include_self=True)
    return grid._replace(density=updated.reshape(grid.density.shape))


def occupancy_mask(grid: OccupancyGrid, positions: torch.Tensor) -> torch.Tensor:
    """(...,) bool: True where the containing cell is occupied."""
    return grid.density.reshape(-1)[_flat(grid, _cell_of(grid, positions))] > grid.threshold


def masked_densities(grid: OccupancyGrid, positions: torch.Tensor,
                     densities: torch.Tensor) -> torch.Tensor:
    """Zero density outside occupied cells: a skipped sample adds nothing
    to the volume-rendering weights."""
    m = occupancy_mask(grid, positions)
    return torch.where(m[..., None], densities, torch.zeros_like(densities))
