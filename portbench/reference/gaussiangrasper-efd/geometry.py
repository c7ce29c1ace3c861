"""Geometry of the splat reference: quaternions, the pinhole camera, the
real SH basis and the EWA projection.

Frozen copies, verbatim, from gaussiangrasper_torch at commit d90391f:
core/transforms.py, core/cameras.py, core/sh.py and ops/projection.py.
Plain PyTorch; imports nothing of gaussiangrasper_torch or JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Union

import torch

# --- from gaussiangrasper_torch/core/transforms.py ---

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

# --- from gaussiangrasper_torch/core/cameras.py ---

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

# --- from gaussiangrasper_torch/core/sh.py ---

MAX_DEGREE = 4


NUM_BASES = (MAX_DEGREE + 1) ** 2  # 25


_C0 = 0.28209479177387814


_C1 = 0.4886025119029199


_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)


_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


_BASIS_DEGREE = (0,) + (1,) * 3 + (2,) * 5 + (3,) * 7 + (4,) * 9


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(dirs: torch.Tensor) -> torch.Tensor:
    """All 25 real SH basis functions at unit directions (..., 3) -> (..., 25)."""
    x, y, z = dirs.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    one = torch.ones_like(x)
    bases = [
        _C0 * one,
        -_C1 * y,
        _C1 * z,
        -_C1 * x,
        _C2[0] * xy,
        _C2[1] * yz,
        _C2[2] * (2.0 * zz - xx - yy),
        _C2[3] * xz,
        _C2[4] * (xx - yy),
        _C3[0] * y * (3.0 * xx - yy),
        _C3[1] * xy * z,
        _C3[2] * y * (4.0 * zz - xx - yy),
        _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
        _C3[4] * x * (4.0 * zz - xx - yy),
        _C3[5] * z * (xx - yy),
        _C3[6] * x * (xx - 3.0 * yy),
        _C4[0] * xy * (xx - yy),
        _C4[1] * yz * (3.0 * xx - yy),
        _C4[2] * xy * (7.0 * zz - 1.0),
        _C4[3] * yz * (7.0 * zz - 3.0),
        _C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
        _C4[5] * xz * (7.0 * zz - 3.0),
        _C4[6] * (xx - yy) * (7.0 * zz - 1.0),
        _C4[7] * xz * (xx - 3.0 * yy),
        _C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
    ]
    return torch.stack(bases, dim=-1)


def eval_sh(
    active_degree: Union[int, torch.Tensor], dirs: torch.Tensor, coeffs: torch.Tensor
) -> torch.Tensor:
    """SH colours (..., C) from unit dirs (..., 3) and coeffs (..., K, C),
    K <= 25. Callers add +0.5 and clamp (as the JAX model does)."""
    k = coeffs.shape[-2]
    basis = sh_basis(dirs)[..., :k]
    deg = torch.tensor(_BASIS_DEGREE[:k], device=dirs.device)
    basis = basis * (deg <= active_degree).to(basis.dtype)
    return torch.einsum("...k,...kc->...c", basis, coeffs)

# --- from gaussiangrasper_torch/ops/projection.py ---

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

