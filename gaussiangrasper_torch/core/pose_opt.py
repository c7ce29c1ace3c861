"""Learned camera-pose refinement: a 6-dof tangent delta per camera
(counterpart of the JAX package's core/pose_opt.py).

`apply_pose_delta` composes exp(delta) on the right of a (3, 4)
camera-to-world pose: "SO3xR3" takes the rotation from the last three
entries and the translation as given, "SE3" couples the two through the
V-matrix. `eps` sits inside the square root, so the gradient at a zero
delta is finite. The mode is `GaussianSplatConfig.pose_opt_mode`; the
deltas train in the "camera_opt" optimizer group.
"""

from __future__ import annotations

import torch


def _skew(v: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
    ], dim=-2)


def exp_map_so3(omega: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """so(3) tangent (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues)."""
    theta = torch.sqrt(torch.sum(omega * omega, dim=-1, keepdim=True) + eps)
    k = _skew(omega / theta)
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(k.shape)
    return eye + s * k + (1.0 - c) * (k @ k)


def exp_map_se3(tangent: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """se(3) tangent (..., 6) [rho, omega] -> (..., 3, 4) transform."""
    rho, omega = tangent[..., :3], tangent[..., 3:]
    theta = torch.sqrt(torch.sum(omega * omega, dim=-1, keepdim=True) + eps)
    k = _skew(omega / theta)
    th = theta[..., None]
    s, c = torch.sin(th), torch.cos(th)
    eye = torch.eye(3, dtype=tangent.dtype, device=tangent.device).expand(k.shape)
    kk = k @ k
    rot = eye + s * k + (1.0 - c) * kk
    v = eye + ((1.0 - c) / th) * k + ((th - s) / th) * kk
    t = (v @ rho[..., None])[..., 0]
    return torch.cat([rot, t[..., None]], dim=-1)


def init_pose_deltas(num_cameras: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Zero 6-dof tangent per camera (identity adjustment)."""
    return torch.zeros((num_cameras, 6), dtype=dtype, device=device)


def apply_pose_delta(camera_to_world: torch.Tensor, delta: torch.Tensor,
                     mode: str = "SO3xR3") -> torch.Tensor:
    """A (3, 4) c2w pose with exp(delta) composed on its right."""
    if mode == "off":
        return camera_to_world
    if mode == "SO3xR3":
        adj = torch.cat([exp_map_so3(delta[3:]), delta[:3, None]], dim=-1)
    elif mode == "SE3":
        adj = exp_map_se3(delta)
    else:
        raise ValueError(mode)
    rot = camera_to_world[:3, :3]
    r = rot @ adj[:3, :3]
    t = rot @ adj[:3, 3] + camera_to_world[:3, 3]
    return torch.cat([r, t[:, None]], dim=-1)
