"""Field encodings: positional (NeRF), spherical harmonics, multiresolution
hash grid (counterpart of the JAX package's models/encodings.py).

The hash grid is a gather from one (L, 2^H, F) table with trilinear
weights, in plain torch ops; autograd's backward of the gather is a
scatter-add into the table."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from gaussiangrasper_torch.core import sh as sh_mod

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
# the 8 cell corners, (i, j, k) with k fastest
_OFFSETS = tuple((i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1))


def positional_encoding(x: torch.Tensor, num_freqs: int,
                        include_input: bool = True) -> torch.Tensor:
    """NeRF sin/cos encoding at frequencies 2^0..2^(L-1) (times pi)."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    scaled = x[..., None] * freqs  # (..., D, L)
    enc = torch.cat([torch.sin(math.pi * scaled), torch.cos(math.pi * scaled)], dim=-1)
    enc = enc.reshape(*x.shape[:-1], -1)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def sh_encoding(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Direction encoding by the real SH basis up to `degree`."""
    return sh_mod.sh_basis(dirs)[..., : sh_mod.num_sh_bases(degree)]


def grid_resolutions(num_levels: int, base_res: int, max_res: int) -> torch.Tensor:
    """floor(base_res * growth^l), growth = (max_res / base_res)^(1/(L-1)).

    Evaluated in float64 (with a 1e-9 relative guard for the levels whose
    value is an integer, the last one = max_res among them) and returned in
    float32. The JAX package evaluates it in float32, where exp can land an
    ulp below an integer and floor drops a level by one; at the JAX
    package's registered grids (4, 5, 12 and 16 levels up to 256 / 2048)
    both give the same resolutions, and converted params carry the JAX
    package's own buffer."""
    ratio = math.log(max_res / base_res) / max(num_levels - 1, 1) if num_levels > 1 else 0.0
    res = [math.floor(base_res * math.exp(ratio * level) * (1.0 + 1e-9))
           for level in range(num_levels)]
    return torch.tensor(res, dtype=torch.float32)


class HashGrid(nn.Module):
    """The hash table `table` (L, 2^H, F), a parameter, and the per-level
    `resolutions` (L,), a buffer (the lookup does not differentiate it)."""

    def __init__(self, num_levels: int = 16, features_per_level: int = 2,
                 log2_hashmap_size: int = 19, base_res: int = 16, max_res: int = 2048,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        shape = (num_levels, 2 ** log2_hashmap_size, features_per_level)
        # U(-1e-4, 1e-4)
        self.table = nn.Parameter((torch.rand(shape, generator=generator) * 2.0 - 1.0) * 1e-4)
        self.register_buffer("resolutions", grid_resolutions(num_levels, base_res, max_res))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hash_grid_encode(self, x)


def init_hash_grid(num_levels: int = 16, features_per_level: int = 2,
                   log2_hashmap_size: int = 19, base_res: int = 16, max_res: int = 2048,
                   generator: Optional[torch.Generator] = None) -> HashGrid:
    return HashGrid(num_levels, features_per_level, log2_hashmap_size, base_res, max_res,
                    generator)


def hash_indices(x: torch.Tensor, resolutions: torch.Tensor, hashmap_size: int):
    """(L, N, 8) int64 table rows of each point's 8 corners at each level
    and (L, N, 3) fractional positions, for x (N, 3) in [0, 1].

    The JAX package multiplies uint32 corners by the primes and XORs them,
    wrapping mod 2^32; here each product is taken in int64 (corner < 2^12,
    prime < 2^32) and masked to 32 bits, which gives the same bits."""
    pos = x[None] * resolutions[:, None, None]  # (L, N, 3)
    p0 = torch.floor(pos)
    frac = pos - p0
    offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=x.device)
    corners = p0.to(torch.int64)[:, :, None, :] + offs  # (L, N, 8, 3)
    h = ((corners[..., 0] * _PRIMES[0]) & _U32) \
        ^ ((corners[..., 1] * _PRIMES[1]) & _U32) \
        ^ ((corners[..., 2] * _PRIMES[2]) & _U32)
    return h % hashmap_size, frac


def hash_grid_encode(grid: HashGrid, x: torch.Tensor) -> torch.Tensor:
    """Trilinear-interpolated hash lookup: x (..., 3) in [0, 1] ->
    (..., L * F)."""
    table = grid.table
    num_levels, hashmap_size, f = table.shape
    batch = x.shape[:-1]
    xf = x.reshape(-1, 3)
    h, frac = hash_indices(xf, grid.resolutions.detach(), hashmap_size)
    rows = h + (torch.arange(num_levels, device=x.device) * hashmap_size)[:, None, None]
    vals = table.reshape(num_levels * hashmap_size, f)[rows]  # (L, N, 8, F)
    offs = torch.tensor(_OFFSETS, device=x.device)
    axis_w = torch.where(offs == 1, frac[:, :, None, :], 1.0 - frac[:, :, None, :])
    w = axis_w[..., 0] * axis_w[..., 1] * axis_w[..., 2]  # (L, N, 8)
    feats = torch.sum(vals * w[..., None], dim=2)  # (L, N, F)
    return feats.permute(1, 0, 2).reshape(*batch, num_levels * f)
