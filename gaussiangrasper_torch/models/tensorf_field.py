"""TensoRF field: the vector-matrix (VM) decomposed radiance grid
(counterpart of the JAX package's models/tensorf_field.py).

Density and appearance live in three axis-aligned plane + line factor
pairs; the plane lookups are bilinear gathers over (3, R, R, C) tensors and
the appearance projection one matmul."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from gaussiangrasper_torch.models.efd import MLP
from gaussiangrasper_torch.models.encodings import positional_encoding

# plane k sees coordinate pair _PLANE_AXES[k], line k sees _LINE_AXIS[k]
_PLANE_AXES = ((0, 1), (0, 2), (1, 2))
_LINE_AXIS = (2, 1, 0)


def init_tensorf(resolution: int = 128, density_components: int = 8,
                 appearance_components: int = 24, appearance_dim: int = 27, hidden: int = 64,
                 generator: Optional[torch.Generator] = None) -> Dict[str, nn.Module]:
    """The JAX package's parameters by name: factor grids ~ N(0, 0.1), the
    basis projection and the view-dependent colour MLP."""
    r, cd, ca = resolution, density_components, appearance_components

    def randn(*shape):
        return torch.randn(shape, generator=generator)

    return {
        "density_planes": nn.Parameter(0.1 * randn(3, r, r, cd)),
        "density_lines": nn.Parameter(0.1 * randn(3, r, cd)),
        "app_planes": nn.Parameter(0.1 * randn(3, r, r, ca)),
        "app_lines": nn.Parameter(0.1 * randn(3, r, ca)),
        "basis": nn.Parameter(randn(3 * ca, appearance_dim) / math.sqrt(3.0 * ca)),
        # appearance features + PE(dirs, 2 freqs with the input): 15 dims
        "color_mlp": MLP(appearance_dim + 15, 3, (hidden, hidden), generator),
    }


def _bilerp_plane(plane: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """plane (R, R, C), uv (..., 2) in [0, 1] -> (..., C)."""
    r = plane.shape[0]
    pos = torch.clamp(uv, 0.0, 1.0) * (r - 1)
    p0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, r - 2)
    f = pos - p0
    x0, y0 = p0[..., 0], p0[..., 1]
    fx, fy = f[..., 0:1], f[..., 1:2]
    return (plane[x0, y0] * (1 - fx) * (1 - fy)
            + plane[x0, y0 + 1] * (1 - fx) * fy
            + plane[x0 + 1, y0] * fx * (1 - fy)
            + plane[x0 + 1, y0 + 1] * fx * fy)


def _lerp_line(line: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """line (R, C), u (...,) in [0, 1] -> (..., C)."""
    r = line.shape[0]
    pos = torch.clamp(u, 0.0, 1.0) * (r - 1)
    p0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, r - 2)
    f = (pos - p0)[..., None]
    return line[p0] * (1 - f) + line[p0 + 1] * f


def _factors(planes: torch.Tensor, lines: torch.Tensor, x01: torch.Tensor, k: int):
    a, b = _PLANE_AXES[k]
    return (_bilerp_plane(planes[k], x01[..., [a, b]]),
            _lerp_line(lines[k], x01[..., _LINE_AXIS[k]]))


def tensorf_density(p, x01: torch.Tensor) -> torch.Tensor:
    """x01 (..., 3) in [0, 1] -> density (..., 1): softplus of the summed
    plane * line features, shifted by -5."""
    total = 0.0
    for k in range(3):
        pf, lf = _factors(p.density_planes, p.density_lines, x01, k)
        total = total + torch.sum(pf * lf, dim=-1)
    return torch.nn.functional.softplus(total - 5.0)[..., None]


def tensorf_rgb(p, x01: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """Appearance: the per-axis plane * line features, projected through the
    basis, decoded by the view-conditioned MLP."""
    feats = []
    for k in range(3):
        pf, lf = _factors(p.app_planes, p.app_lines, x01, k)
        feats.append(pf * lf)
    app = torch.cat(feats, dim=-1) @ p.basis
    d_enc = positional_encoding(directions, 2, include_input=True)
    return torch.sigmoid(p.color_mlp(torch.cat([app, d_enc], dim=-1)))


def tensorf_l1_reg(p) -> torch.Tensor:
    """L1 sparsity on the density factors."""
    return torch.mean(torch.abs(p.density_planes)) + torch.mean(torch.abs(p.density_lines))
