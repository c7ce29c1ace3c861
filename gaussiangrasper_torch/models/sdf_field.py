"""NeuS-style SDF field: signed distance and logistic-CDF alpha rendering
(counterpart of the JAX package's models/sdf_field.py).

  - "neus":       positional-encoded SDF MLP
  - "neus-facto": multiresolution hash-grid features + a small SDF head

The SDF's spatial gradient (the alpha estimator's cos term, the normals and
the eikonal loss) comes from `torch.autograd.grad` with `create_graph`, so
the loss differentiates through it (a double backward through the ReLU
MLP); under `torch.no_grad` it is taken locally with grad enabled."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from gaussiangrasper_torch.models.efd import MLP
from gaussiangrasper_torch.models.encodings import (
    hash_grid_encode,
    init_hash_grid,
    positional_encoding,
)


def init_sdf_field(variant: str = "neus", pos_freqs: int = 6, hidden: int = 128,
                   geo_features: int = 15, hash_levels: int = 12, log2_hashmap_size: int = 17,
                   generator: Optional[torch.Generator] = None) -> Dict[str, nn.Module]:
    """The JAX package's parameters by name: `s` (inv_std = exp(10 s),
    0.05 at init), `grid` for neus-facto, `sdf_mlp` (its last bias's sdf
    entry 0.5) and `color_mlp`."""
    params: Dict = {"s": nn.Parameter(torch.tensor(0.05, dtype=torch.float32))}
    if variant == "neus-facto":
        params["grid"] = init_hash_grid(num_levels=hash_levels, features_per_level=2,
                                        log2_hashmap_size=log2_hashmap_size,
                                        generator=generator)
        in_dim = hash_levels * 2 + 3
    else:
        in_dim = 3 + 6 * pos_freqs
    sdf_mlp = MLP(in_dim, 1 + geo_features, (hidden, hidden), generator)
    with torch.no_grad():
        getattr(sdf_mlp, f"b{sdf_mlp.num_layers - 1}")[0] = 0.5
    params["sdf_mlp"] = sdf_mlp
    # colour head: position + normal + view-direction PE + geo features
    params["color_mlp"] = MLP(3 + 3 + (3 + 6 * 2) + geo_features, 3, (hidden,), generator)
    return params


def sdf_and_features(p, positions: torch.Tensor, scene_scale: float,
                     pos_freqs: int = 6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sdf (..., 1), geo features (..., G))."""
    grid = getattr(p, "grid", None)
    if grid is not None:
        x01 = torch.clamp(positions / (2 * scene_scale) + 0.5, 0.0, 1.0)
        enc = torch.cat([positions, hash_grid_encode(grid, x01)], dim=-1)
    else:
        enc = positional_encoding(positions, pos_freqs)
    h = p.sdf_mlp(enc)
    return h[..., :1], h[..., 1:]


def sdf_value(p, positions, scene_scale, pos_freqs=6):
    return sdf_and_features(p, positions, scene_scale, pos_freqs)[0][..., 0]


def sdf_gradient(p, positions: torch.Tensor, scene_scale: float,
                 pos_freqs: int = 6) -> torch.Tensor:
    """The SDF's spatial gradient at positions (..., 3). Differentiable
    (create_graph) when grad is enabled at the call."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        x = positions.detach().reshape(-1, 3).requires_grad_(True)
        total = torch.sum(sdf_value(p, x, scene_scale, pos_freqs))
        (g,) = torch.autograd.grad(total, x, create_graph=create)
    return g.reshape(positions.shape)


def neus_alphas(sdf: torch.Tensor, grad: torch.Tensor, directions: torch.Tensor,
                deltas: torch.Tensor, inv_std: torch.Tensor, cos_anneal: float = 1.0
                ) -> torch.Tensor:
    """The NeuS unbiased alpha estimator: section-endpoint SDFs from the
    midpoint value and the directional derivative, then
    alpha = (Phi(prev) - Phi(next)) / Phi(prev)."""
    cos = torch.sum(grad * directions, dim=-1, keepdim=True)
    # annealed, clamped to non-positive (surfaces face the camera)
    cos = -(torch.relu(-cos * 0.5 + 0.5) * (1.0 - cos_anneal) + torch.relu(-cos) * cos_anneal)
    est_prev = sdf - cos * deltas * 0.5
    est_next = sdf + cos * deltas * 0.5
    cdf_prev = torch.sigmoid(est_prev * inv_std)
    cdf_next = torch.sigmoid(est_next * inv_std)
    return torch.clamp((cdf_prev - cdf_next + 1e-5) / (cdf_prev + 1e-5), 0.0, 1.0)


def alphas_to_weights(alphas: torch.Tensor) -> torch.Tensor:
    """Front-to-back compositing weights from per-sample alphas."""
    trans = torch.cumprod(torch.cat([torch.ones_like(alphas[..., :1, :]),
                                     1.0 - alphas[..., :-1, :] + 1e-7], dim=-2), dim=-2)
    return alphas * trans


def sdf_rgb(p, positions: torch.Tensor, directions: torch.Tensor, normals: torch.Tensor,
            geo: torch.Tensor) -> torch.Tensor:
    """IDR-style colour head conditioned on (x, n, v, geo)."""
    d_enc = positional_encoding(directions, 2)
    h = torch.cat([positions, normals, d_enc, geo], dim=-1)
    return torch.sigmoid(p.color_mlp(h))
