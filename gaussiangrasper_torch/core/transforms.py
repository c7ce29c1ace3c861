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


def rotmat_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations -> (..., 4) unit quaternions, w >= 0.
    Shepperd's method without branches: all four candidates, the one with
    the largest pivot kept (the first on ties, as `jnp.argmax` and
    `torch.argmax` both take it)."""
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    tr = m00 + m11 + m22
    # each candidate is 4 * component * q, scaled by its pivot 4 * component^2
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                          1.0 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, 4)
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    q = normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w, x, y, z) quaternions, broadcasting over batch."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def rotate_x(theta: float) -> torch.Tensor:
    """Rotation matrix about +X by theta radians (float32)."""
    c, s = math.cos(theta), math.sin(theta)
    return torch.tensor([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]], dtype=torch.float32)
