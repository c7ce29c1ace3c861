"""Brute-force per-pixel reference renderer, the test oracle (counterpart of
the JAX package's ops/oracle.py).

Evaluates every Gaussian at every pixel, independent of the tile
pipeline's binning, sort and capacities. Inclusion is tile-granular, as in
the CUDA reference rasterizer: a Gaussian reaches a pixel iff its radius
square overlaps the pixel's tile, sigma >= 0 and alpha >= 1/255;
compositing stops when transmittance would drop to <= 1e-4."""

from __future__ import annotations

import torch

from gaussiangrasper_torch.ops.projection import ProjectedGaussians
from gaussiangrasper_torch.ops.rasterize import ALPHA_CLAMP, ALPHA_CUTOFF, composite_weights


def render_oracle(
    proj: ProjectedGaussians,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    background: torch.Tensor,
    width: int,
    height: int,
    tile_size: int = 16,
    pixel_chunk: int = 2048,
) -> torch.Tensor:
    """Render (H, W, C) by evaluating all N Gaussians at every pixel."""
    alive = proj.radii > 0.0
    inf = torch.full_like(proj.depths, float("inf"))
    order = torch.argsort(torch.where(alive, proj.depths, inf), stable=True)
    xys = proj.xys[order]
    conics = proj.conics[order]
    radii = proj.radii[order]
    opac = torch.where(alive[order], opacities[order], torch.zeros_like(opacities[order]))
    cols = colors[order]

    tw = -(-width // tile_size)
    th = -(-height // tile_size)
    x0t = torch.clamp(torch.floor((xys[:, 0] - radii) / tile_size), 0, tw)
    y0t = torch.clamp(torch.floor((xys[:, 1] - radii) / tile_size), 0, th)
    x1t = torch.clamp(torch.floor((xys[:, 0] + radii) / tile_size) + 1, 0, tw)
    y1t = torch.clamp(torch.floor((xys[:, 1] + radii) / tile_size) + 1, 0, th)

    ys, xs = torch.meshgrid(torch.arange(height, device=xys.device),
                            torch.arange(width, device=xys.device), indexing="ij")
    pix = torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1).to(xys.dtype)
    outs = []
    for p in torch.split(pix, pixel_chunk):
        ptx = torch.floor(p[:, 0] / tile_size)
        pty = torch.floor(p[:, 1] / tile_size)
        in_tile = ((x0t[:, None] <= ptx[None, :]) & (ptx[None, :] < x1t[:, None])
                   & (y0t[:, None] <= pty[None, :]) & (pty[None, :] < y1t[:, None]))
        dx = p[None, :, 0] - xys[:, 0:1]
        dy = p[None, :, 1] - xys[:, 1:2]
        sigma = 0.5 * (conics[:, 0:1] * dx * dx + conics[:, 2:3] * dy * dy) + conics[:, 1:2] * dx * dy
        alpha = torch.clamp(opac[:, None] * torch.exp(-sigma), max=ALPHA_CLAMP)
        ok = in_tile & (radii[:, None] > 0) & (sigma >= 0.0) & (alpha >= ALPHA_CUTOFF)
        alpha = torch.where(ok, alpha, torch.zeros_like(alpha))
        weights, t_final = composite_weights(alpha, dim=0)  # (N, chunk), (chunk,)
        outs.append(weights.T @ cols + t_final[:, None] * background[None, :])
    return torch.cat(outs).reshape(height, width, colors.shape[-1])
