"""Scene bounds: axis-aligned and oriented crop boxes (counterpart of the
JAX package's core/scene_box.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaussiangrasper_torch.core.transforms import quat_to_rotmat


class SceneBox(NamedTuple):
    aabb: torch.Tensor  # (2, 3) [min; max]

    def within(self, points: torch.Tensor) -> torch.Tensor:
        lo, hi = self.aabb[0], self.aabb[1]
        return torch.all((points >= lo) & (points <= hi), dim=-1)

    def get_center(self) -> torch.Tensor:
        return 0.5 * (self.aabb[0] + self.aabb[1])


class OrientedBox(NamedTuple):
    """Rotation (quat wxyz) + translation + per-axis size."""

    quat: torch.Tensor         # (4,)
    translation: torch.Tensor  # (3,)
    size: torch.Tensor         # (3,)

    def within(self, points: torch.Tensor) -> torch.Tensor:
        """(N,) bool: inside the oriented box."""
        r = quat_to_rotmat(self.quat)
        local = (points - self.translation) @ r  # R^T @ (p - t)
        half = 0.5 * self.size
        return torch.all(torch.abs(local) <= half, dim=-1)


def aabb_of(points) -> SceneBox:
    points = torch.as_tensor(points)
    return SceneBox(torch.stack([points.min(0).values, points.max(0).values]))
