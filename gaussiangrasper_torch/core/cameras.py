"""Pinhole camera (counterpart of the JAX package's core/cameras.py).

`camera_to_world` is a (3, 4) OpenGL-style pose (x right, y up, z back);
`view_matrix` converts to the rasterizer frame (x right, y down, z forward)
by flipping the y/z columns, then inverts analytically."""

from __future__ import annotations

import dataclasses
import math
from enum import Enum
from typing import Optional, Union

import torch


class CameraType(Enum):
    PERSPECTIVE = 1
    FISHEYE = 2
    EQUIRECTANGULAR = 3


@dataclasses.dataclass(frozen=True)
class Camera:
    fx: torch.Tensor  # 0-d float32
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    camera_to_world: torch.Tensor  # (3, 4) OpenGL c2w
    width: int
    height: int

    @classmethod
    def create(cls, fx, fy, cx, cy, camera_to_world, width: int, height: int,
               device: Optional[Union[str, torch.device]] = None) -> "Camera":
        def f32(v):
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        return cls(fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy),
                   camera_to_world=f32(camera_to_world),
                   width=int(width), height=int(height))

    def rescale(self, scale: float) -> "Camera":
        """Rescaled output resolution; width/height floor, as the JAX
        package and the reference's `rescale_output_resolution` do."""
        return Camera(
            fx=self.fx * scale, fy=self.fy * scale,
            cx=self.cx * scale, cy=self.cy * scale,
            camera_to_world=self.camera_to_world,
            width=int(self.width * scale), height=int(self.height * scale),
        )

    @property
    def origin(self) -> torch.Tensor:
        return self.camera_to_world[:3, 3]


def view_matrix(camera_to_world: torch.Tensor) -> torch.Tensor:
    """World-to-camera (4, 4) in the rasterizer frame (z forward)."""
    flip = torch.tensor([1.0, -1.0, -1.0], dtype=camera_to_world.dtype,
                        device=camera_to_world.device)
    R = camera_to_world[:3, :3] * flip
    t = camera_to_world[:3, 3:4]
    R_inv = R.T
    view = torch.eye(4, dtype=camera_to_world.dtype, device=camera_to_world.device)
    view[:3, :3] = R_inv
    view[:3, 3:4] = -R_inv @ t
    return view


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> torch.Tensor:
    """OpenGL-style perspective projection (float32). The rasterizer projects
    from the intrinsics; this is the same map for a symmetric frustum."""
    t = znear * math.tan(0.5 * fovy)
    r = znear * math.tan(0.5 * fovx)
    n, f = znear, zfar
    return torch.tensor([
        [n / r, 0.0, 0.0, 0.0],
        [0.0, n / t, 0.0, 0.0],
        [0.0, 0.0, (f + n) / (f - n), -f * n / (f - n)],
        [0.0, 0.0, 1.0, 0.0],
    ], dtype=torch.float32)
