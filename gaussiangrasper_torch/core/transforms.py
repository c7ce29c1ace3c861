"""Quaternion and rotation primitives (counterpart of
the JAX package's core/transforms.py). Quaternions are (w, x, y, z)."""

from __future__ import annotations

import math

import torch


def normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along `dim` (safe at zero)."""
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions -> (..., 3, 3) rotations; normalizes internally."""
    q = normalize(quat)
    w, x, y, z = q.unbind(-1)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def random_quats(uniforms: torch.Tensor) -> torch.Tensor:
    """Uniformly random unit quaternions (n, 4) from injected uniforms
    (3, n) in [0, 1): the Marsaglia/Shoemake construction of the JAX
    package's `random_quats`, which draws the same three rows from a key."""
    u, v, w = uniforms.unbind(0)
    return torch.stack(
        [
            torch.sqrt(1.0 - u) * torch.sin(2.0 * math.pi * v),
            torch.sqrt(1.0 - u) * torch.cos(2.0 * math.pi * v),
            torch.sqrt(u) * torch.sin(2.0 * math.pi * w),
            torch.sqrt(u) * torch.cos(2.0 * math.pi * w),
        ],
        dim=-1,
    )
