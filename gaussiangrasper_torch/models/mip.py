"""Mip-NeRF primitives: conical frustums as Gaussians and the integrated
positional encoding (counterpart of the JAX package's models/mip.py).
Closed-form elementwise math over (rays, samples) tensors."""

from __future__ import annotations

import math
from typing import Tuple

import torch


def conical_frustum_to_gaussian(
    origins: torch.Tensor,     # (..., 3)
    directions: torch.Tensor,  # (..., 3) unit
    starts: torch.Tensor,      # (..., S) frustum near ts
    ends: torch.Tensor,        # (..., S) frustum far ts
    radius: torch.Tensor,      # (..., 1) cone radius at unit distance
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each conical frustum as a Gaussian in the stable parameterization of
    the mip-NeRF paper (eq. 7): (means (..., S, 3), cov_diag (..., S, 3))."""
    mu = 0.5 * (starts + ends)
    hw = 0.5 * (ends - starts)
    mu2, hw2 = mu * mu, hw * hw
    denom = 3.0 * mu2 + hw2
    t_mean = mu + (2.0 * mu * hw2) / denom
    t_var = hw2 / 3.0 - (4.0 / 15.0) * (hw2 * hw2 * (12.0 * mu2 - hw2)) / (denom * denom)
    r_var = radius * radius * (mu2 / 4.0 + (5.0 / 12.0) * hw2 - (4.0 / 15.0) * (hw2 * hw2) / denom)

    means = origins[..., None, :] + directions[..., None, :] * t_mean[..., None]
    d2 = directions * directions
    d_norm2 = torch.clamp(torch.sum(d2, dim=-1, keepdim=True), min=1e-10)
    # diagonal of t_var * d d^T + r_var * (I - d d^T / ||d||^2)
    cov_diag = (t_var[..., None] * d2[..., None, :]
                + r_var[..., None] * (1.0 - d2[..., None, :] / d_norm2[..., None, :]))
    return means, cov_diag


def integrated_pos_enc(means: torch.Tensor, cov_diag: torch.Tensor,
                       num_freqs: int) -> torch.Tensor:
    """E[sin(2^l x)] = sin(2^l mu) exp(-0.5 4^l var), and cos alike:
    (..., 6 * num_freqs)."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=means.dtype, device=means.device)
    scaled = means[..., None] * freqs            # (..., 3, L)
    var = cov_diag[..., None] * (freqs * freqs)  # (..., 3, L)
    damp = torch.exp(-0.5 * var)
    enc = torch.cat([torch.sin(scaled) * damp, torch.cos(scaled) * damp], dim=-1)
    return enc.reshape(*means.shape[:-1], -1)


def pixel_radius(pixel_area: torch.Tensor) -> torch.Tensor:
    """Cone radius at unit distance from the pixel footprint:
    2 / sqrt(12) * pixel width."""
    return (2.0 / math.sqrt(12.0)) * torch.sqrt(pixel_area)
