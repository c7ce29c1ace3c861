"""Dataparser output contract + shared pose-normalization utilities (a
copy of the JAX package's data/dataparsers/base.py).

nerfstudio's DataparserOutputs and auto_orient_and_center_poses, in
host-side numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class ParsedCamera:
    """Host-side per-view camera (numpy; becomes core.cameras.Camera on
    device). Nonzero distortion is consumed by the one-time undistortion
    cache (data/manager.undistort_image)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    camera_to_world: np.ndarray  # (3, 4) OpenGL convention
    distortion: np.ndarray = field(default_factory=lambda: np.zeros(6))
    camera_type: str = "perspective"  # or "fisheye"


@dataclass
class DataparserOutputs:
    image_filenames: List[Path]
    cameras: List[ParsedCamera]
    dataparser_scale: float
    dataparser_transform: np.ndarray  # (3, 4) applied to world
    metadata: Dict[str, Any] = field(default_factory=dict)
    mask_filenames: Optional[List[Path]] = None

    @property
    def seed_points(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        xyz = self.metadata.get("points3D_xyz")
        rgb = self.metadata.get("points3D_rgb")
        if xyz is None:
            return None
        return xyz, rgb


def focus_of_attention(poses: np.ndarray, initial: np.ndarray) -> np.ndarray:
    """Least-squares nearest point to all camera optical axes
    (nerfstudio's camera_utils.focus_of_attention)."""
    dirs = -poses[:, :3, 2:3]  # OpenGL looks down -z
    origins = poses[:, :3, 3:4]
    m = np.eye(3) - dirs * dirs.transpose(0, 2, 1)
    mtm = m.transpose(0, 2, 1) @ m
    a = mtm.sum(0)
    b = (mtm @ origins).sum(0)
    try:
        return np.linalg.solve(a, b)[:, 0]
    except np.linalg.LinAlgError:
        return initial


def auto_orient_and_center_poses(
    poses: np.ndarray,
    method: str = "up",
    center_method: str = "poses",
) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate the mean up-vector to +z and translate the center to the
    origin. poses: (N, 3, 4) OpenGL c2w. Returns (new_poses, transform
    (3, 4)) with new = transform @ [pose; 0 0 0 1]."""
    origins = poses[:, :3, 3]
    mean_origin = origins.mean(0)
    if center_method == "poses":
        translation = mean_origin
    elif center_method == "focus":
        translation = focus_of_attention(poses, mean_origin)
    else:
        translation = np.zeros(3)

    if method == "up":
        up = poses[:, :3, 1].mean(0)
        up = up / np.linalg.norm(up)
        rotation = _rotation_between(up, np.array([0.0, 0.0, 1.0]))
    elif method == "none":
        rotation = np.eye(3)
    else:
        raise ValueError(method)

    transform = np.concatenate([rotation, rotation @ -translation[:, None]], axis=1)
    bottom = np.array([[[0.0, 0.0, 0.0, 1.0]]]).repeat(len(poses), 0)
    full = np.concatenate([poses, bottom], axis=1)
    new_poses = np.einsum("ij,njk->nik", transform, full)
    return new_poses, transform


def _rotation_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit vector a to unit vector b (Rodrigues)."""
    v = np.cross(a, b)
    c = float(a @ b)
    if np.linalg.norm(v) < 1e-10:
        return np.eye(3) if c > 0 else -np.eye(3)
    skew = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + skew + skew @ skew * (1.0 / (1.0 + c))


def apply_transform_to_points(transform: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ transform[:3, :3].T + transform[:3, 3]
