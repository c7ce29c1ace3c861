"""The language-embedded Gaussian-splatting model's render path
(counterpart of the JAX package's models/model.py, serving subset).

ONE fused rasterization pass over 3 + F + 1 + 3 channels (rgb, latent
feature, depth, normal). The training loss, the densification probe, pose
deltas and the tile-sharded compositor come with later slices."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from gaussiangrasper_torch._device import full_f32
from gaussiangrasper_torch.core import sh
from gaussiangrasper_torch.core.cameras import Camera, view_matrix
from gaussiangrasper_torch.core.transforms import quat_to_rotmat
from gaussiangrasper_torch.models import losses
from gaussiangrasper_torch.models.gaussian_field import GaussianParams
from gaussiangrasper_torch.ops.projection import project_gaussians
from gaussiangrasper_torch.ops.rasterize import RasterizeConfig, rasterize_projected


@dataclasses.dataclass(frozen=True)
class GaussianSplatConfig:
    """Same fields and defaults as the JAX package's GaussianSplatConfig,
    so a saved model config loads into either package."""

    warmup_length: int = 500
    refine_every: int = 100
    resolution_schedule: int = 250
    num_downscales: int = 1
    cull_alpha_thresh: float = 0.1
    cull_scale_thresh: float = 0.5
    reset_alpha_every: int = 30
    densify_grad_thresh: float = 0.0002
    densify_size_thresh: float = 0.01
    n_split_samples: int = 2
    sh_degree_interval: int = 1000
    cull_screen_size: float = 0.15
    split_screen_size: float = 0.05
    stop_screen_size_at: int = 4000
    random_init: bool = False
    ssim_lambda: float = 0.2
    stop_split_at: int = 15000
    sh_degree: int = 4
    max_gauss_ratio: float = 10.0
    feature_dim: int = 32
    clip_dim: int = 512
    depth_background: float = 10.0
    sky_alpha_reg: float = 0.0
    pose_opt_mode: str = "off"
    raster: RasterizeConfig = RasterizeConfig()

    @property
    def num_channels(self) -> int:
        return 3 + self.feature_dim + 1 + 3

    def background(self, device=None) -> torch.Tensor:
        """Channel backgrounds: rgb 0, feature 0, depth 10, normal 0."""
        bg = torch.zeros(self.num_channels, dtype=torch.float32, device=device)
        bg[3 + self.feature_dim] = self.depth_background
        return bg

    @classmethod
    def from_dict(cls, payload: Dict[str, Any]) -> "GaussianSplatConfig":
        payload = dict(payload)
        raster = RasterizeConfig(**payload.pop("raster", {}))
        return cls(raster=raster, **payload)


def smallest_axis_normals(log_scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian normal = rotation column of the smallest scale axis
    (first axis on ties, as argmin)."""
    R = quat_to_rotmat(quats)  # (N, 3, 3)
    idx = torch.argmin(log_scales, dim=-1)
    return torch.gather(R, 2, idx[:, None, None].expand(-1, 3, 1))[..., 0]


def active_sh_degree(step: Union[int, torch.Tensor], cfg: GaussianSplatConfig):
    return min(int(step) // cfg.sh_degree_interval, cfg.sh_degree)


def render_inputs(field: GaussianParams, alive: torch.Tensor, camera: Camera,
                  step: Union[int, torch.Tensor], cfg: GaussianSplatConfig,
                  crop_mask: Optional[torch.Tensor] = None):
    """What `render` hands the rasterizer: (projection, fused colours
    (N, 3 + F + 1 + 3), opacities (N,), background (C,))."""
    vm = view_matrix(camera.camera_to_world)
    mask = alive if crop_mask is None else (alive & crop_mask)
    proj = project_gaussians(
        field.means, torch.exp(field.log_scales), field.quats, vm,
        camera.fx, camera.fy, camera.cx, camera.cy, camera.width, camera.height,
        mask=mask,
    )
    viewdirs = field.means.detach() - camera.origin[None, :]
    viewdirs = viewdirs / losses.safe_norm(viewdirs)
    rgbs = torch.clamp(
        sh.eval_sh(active_sh_degree(step, cfg), viewdirs, field.sh_coeffs) + 0.5, 0.0, 1.0)
    normals = smallest_axis_normals(field.log_scales, field.quats)
    colors = torch.cat([rgbs, field.features, proj.depths[:, None], normals], dim=-1)
    return proj, colors, torch.sigmoid(field.opacity_logits), cfg.background(field.means.device)


def render(
    field: GaussianParams,
    alive: torch.Tensor,
    camera: Camera,
    step: Union[int, torch.Tensor],
    cfg: GaussianSplatConfig,
    *,
    crop_mask: Optional[torch.Tensor] = None,
) -> Dict[str, Any]:
    """Render rgb / feature / depth / normal maps for one camera. Returns
    per-channel images, alpha, the projection and the binning stats."""
    F = cfg.feature_dim
    proj, colors, opac, bg = render_inputs(field, alive, camera, step, cfg, crop_mask)
    out = rasterize_projected(proj, colors, opac, bg, camera.width, camera.height, cfg.raster)
    img = out["image"]
    return {
        "rgb": img[..., 0:3],
        "feature": img[..., 3: 3 + F],
        "depth": img[..., 3 + F: 4 + F],
        "normal": img[..., 4 + F: 7 + F],
        "normal_vis": (img[..., 4 + F: 7 + F] + 1.0) / 2.0,
        "alpha": out["alpha"],
        "proj": proj,
        "bins": out["bins"],
    }


def feature_pca_vis(feature_map: torch.Tensor) -> torch.Tensor:
    """(H, W, F) feature map -> (H, W, 3) in [0, 1] through its top three
    principal components (eigenvector signs are arbitrary)."""
    h, w, f = feature_map.shape
    flat = feature_map.reshape(-1, f)
    centered = flat - flat.mean(0, keepdim=True)
    with full_f32():
        cov = centered.T @ centered / flat.shape[0]
        _, vecs = torch.linalg.eigh(cov)  # ascending
        proj = flat @ vecs[:, -3:].flip(-1)
    lo = torch.quantile(proj, 0.02, dim=0)
    hi = torch.quantile(proj, 0.98, dim=0)
    return torch.clamp((proj - lo) / (hi - lo + 1e-8), 0, 1).reshape(h, w, 3)
