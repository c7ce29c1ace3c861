"""Perspective projection of 3D Gaussians to screen space (EWA splatting);
counterpart of the JAX package's ops/projection.py.

Conventions (gsplat-0.1.0 semantics, as the JAX package):
- 3D covariance Sigma = R S S^T R^T from (quat, linear scales).
- depth <= clip_thresh (0.01), det <= 0, or mask False culls the Gaussian.
- EWA Jacobian with tan-FOV clamping at 1.3x the half-FOV.
- +eps2d (0.3 px) on the 2D covariance diagonal.
- conic = inverse 2D covariance; radius = ceil(3 * sqrt(lambda_max)) with
  the eigenvalue discriminant floored at 0.1.
- pixel centres at integer coordinates: xys = f * x/z + c - 0.5.
- culled rows are zeroed in every output.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gaussiangrasper_torch.core.transforms import normalize, quat_to_rotmat


class ProjectedGaussians(NamedTuple):
    xys: torch.Tensor     # (N, 2) pixel-space centres
    depths: torch.Tensor  # (N,) camera-frame z
    conics: torch.Tensor  # (N, 3) inverse 2D covariance (a, b, c)
    radii: torch.Tensor   # (N,) float radius in pixels; 0 => culled
    cov2d: torch.Tensor   # (N, 3) 2D covariance (A, B, C)


def compute_cov3d(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) covariance from linear scales (N, 3) and quats (N, 4)."""
    R = quat_to_rotmat(quats)
    M = R * scales[..., None, :]
    return M @ M.transpose(-1, -2)


def project_gaussians(
    means: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    viewmat: torch.Tensor,
    fx,
    fy,
    cx,
    cy,
    width: int,
    height: int,
    *,
    eps2d: float = 0.3,
    clip_thresh: float = 0.01,
    mask: Optional[torch.Tensor] = None,
) -> ProjectedGaussians:
    """Project N Gaussians: means (N, 3) world, scales (N, 3) linear,
    quats (N, 4) (w,x,y,z), viewmat (4, 4) world-to-camera (z forward)."""
    R_v = viewmat[:3, :3]
    t_v = viewmat[:3, 3]
    p_cam = means @ R_v.T + t_v
    x_c, y_c, z_c = p_cam.unbind(-1)

    valid = z_c > clip_thresh
    if mask is not None:
        valid = valid & mask
    z_safe = torch.where(valid, z_c, torch.ones_like(z_c))

    cov3d = compute_cov3d(scales, normalize(quats))
    cov_cam = R_v @ cov3d @ R_v.T

    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x = 1.3 * tan_fovx
    lim_y = 1.3 * tan_fovy
    tx = z_safe * torch.clamp(x_c / z_safe, -lim_x, lim_x)
    ty = z_safe * torch.clamp(y_c / z_safe, -lim_y, lim_y)

    rz = 1.0 / z_safe
    rz2 = rz * rz
    j00 = fx * rz
    j02 = -fx * tx * rz2
    j11 = fy * rz
    j12 = -fy * ty * rz2

    c00 = cov_cam[:, 0, 0]
    c01 = cov_cam[:, 0, 1]
    c02 = cov_cam[:, 0, 2]
    c11 = cov_cam[:, 1, 1]
    c12 = cov_cam[:, 1, 2]
    c22 = cov_cam[:, 2, 2]
    # J cov_cam J^T written out (J is 2x3 with two zeros)
    a0 = j00 * c00 + j02 * c02
    a1 = j00 * c01 + j02 * c12
    a2 = j00 * c02 + j02 * c22
    b1 = j11 * c11 + j12 * c12
    b2 = j11 * c12 + j12 * c22
    A = a0 * j00 + a2 * j02 + eps2d
    B = a1 * j11 + a2 * j12
    C = b1 * j11 + b2 * j12 + eps2d

    det = A * C - B * B
    valid = valid & (det > 0.0)
    det_safe = torch.where(det > 0.0, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    conics = torch.stack([C * inv_det, -B * inv_det, A * inv_det], dim=-1)

    b_half = 0.5 * (A + C)
    v1 = b_half + torch.sqrt(torch.clamp(b_half * b_half - det_safe, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(v1, min=0.0)))

    xys = torch.stack([fx * x_c / z_safe + cx - 0.5, fy * y_c / z_safe + cy - 0.5], dim=-1)

    zero = torch.zeros((), dtype=means.dtype, device=means.device)
    v2 = valid[:, None]
    return ProjectedGaussians(
        xys=torch.where(v2, xys, zero),
        depths=torch.where(valid, z_c, zero),
        conics=torch.where(v2, conics, zero),
        radii=torch.where(valid, radius, zero),
        cov2d=torch.where(v2, torch.stack([A, B, C], dim=-1), zero),
    )
