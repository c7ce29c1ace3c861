"""The language-embedded Gaussian-splatting model: render and training
loss (counterpart of the JAX package's models/model.py).

ONE fused rasterization pass over 3 + F + 1 + 3 channels (rgb, latent
feature, depth, normal). The screen-space gradient statistics that drive
densification come from a zero `probe` added to the projected centres, so
one backward gives the parameter gradients and dL/dxy. `compositor`
swaps in another rasterizer with `rasterize_projected`'s signature (a
closure that passes table bins, say), as in the JAX package."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from gaussiangrasper_torch._device import full_f32
from gaussiangrasper_torch.core import sh
from gaussiangrasper_torch.core.cameras import Camera, view_matrix
from gaussiangrasper_torch.core.pose_opt import apply_pose_delta
from gaussiangrasper_torch.core.transforms import quat_to_rotmat
from gaussiangrasper_torch.models import losses
from gaussiangrasper_torch.models.efd import mlp_apply
from gaussiangrasper_torch.models.gaussian_field import GaussianParams
from gaussiangrasper_torch.ops.projection import project_gaussians
from gaussiangrasper_torch.ops.rasterize import RasterizeConfig, rasterize_projected
from gaussiangrasper_torch.utils.profiler import PROFILER


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
                  crop_mask: Optional[torch.Tensor] = None, probe: Optional[torch.Tensor] = None):
    """What `render` hands the rasterizer: (projection, fused colours
    (N, 3 + F + 1 + 3), opacities (N,), background (C,)). `probe` (N, 2),
    zero-valued, is added to the projected centres so its gradient is
    dL/dxy."""
    vm = view_matrix(camera.camera_to_world)
    mask = alive if crop_mask is None else (alive & crop_mask)
    proj = project_gaussians(
        field.means, torch.exp(field.log_scales), field.quats, vm,
        camera.fx, camera.fy, camera.cx, camera.cy, camera.width, camera.height,
        mask=mask,
    )
    if probe is not None:
        proj = proj._replace(xys=proj.xys + probe)
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
    probe: Optional[torch.Tensor] = None,
    pose_delta: Optional[torch.Tensor] = None,
    compositor: Optional[Callable[..., Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """Render rgb / feature / depth / normal maps for one camera. Returns
    per-channel images, alpha, the projection and the binning stats.
    `pose_delta` (6,) adjusts the camera's pose (`cfg.pose_opt_mode`)
    before anything is projected; `compositor(proj, colors, opacities, bg,
    width, height, raster_config)` replaces `rasterize_projected`."""
    F = cfg.feature_dim
    if pose_delta is not None and cfg.pose_opt_mode != "off":
        camera = dataclasses.replace(camera, camera_to_world=apply_pose_delta(
            camera.camera_to_world, pose_delta, cfg.pose_opt_mode))
    with PROFILER.section("project"):
        proj, colors, opac, bg = render_inputs(field, alive, camera, step, cfg, crop_mask, probe)
    composite = compositor if compositor is not None else rasterize_projected
    out = composite(proj, colors, opac, bg, camera.width, camera.height, cfg.raster)
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


def train_loss(
    state: Dict[str, Any],
    alive: torch.Tensor,
    camera: Camera,
    batch: Dict[str, torch.Tensor],
    step: int,
    cfg: GaussianSplatConfig,
    probe: Optional[torch.Tensor] = None,
    compositor: Optional[Callable[..., Dict[str, Any]]] = None,
    field_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Total training loss and aux outputs. `state` holds "field"
    (GaussianParams), "fea_up" (`mlp_apply` params) and, with pose
    optimization, "pose" ((num_cameras, 6) deltas; the batch's "cam_idx"
    picks the row). `field_sum` sums a tensor over the shards of a
    sharded field (the tile-sharded step's regularizers); None when the
    field is whole.

    batch: image (H, W, 3), depth (H, W), normal (H, W, 3), valid_mask
    (H, W) bool, pair_a / pair_b (G, P, 2) int (row, col), pair_valid
    (G, P), group_valid (G,), points (S, 2) int, point_valid (S,),
    gt_clip (S, 512)."""
    field: GaussianParams = state["field"]
    pose_delta = None
    if state.get("pose") is not None and "cam_idx" in batch:
        pose_delta = state["pose"][batch["cam_idx"]]
    outs = render(field, alive, camera, step, cfg, probe=probe, pose_delta=pose_delta,
                  compositor=compositor)

    gt_img = batch["image"]
    valid = batch["valid_mask"]
    depth_gt = batch["depth"]
    depth_mask = (depth_gt > 0.05) & valid
    gt_normal = batch["normal"] / losses.safe_norm(batch["normal"])

    rgb = outs["rgb"]
    l1 = losses.masked_l1(rgb, gt_img, valid)
    vm3 = valid[..., None].to(rgb.dtype)
    sim = 1.0 - losses.ssim(gt_img * vm3, rgb * vm3)
    main_loss = (1.0 - cfg.ssim_lambda) * l1 + cfg.ssim_lambda * sim
    depth_loss = losses.masked_l1(outs["depth"][..., 0], depth_gt, depth_mask)
    normal_l = losses.normal_loss(outs["normal"], gt_normal, depth_mask)

    with PROFILER.section("efd"):
        # one fused pixel gather for pair_a, pair_b and the distillation points
        fea = outs["feature"]
        g, p_, _ = batch["pair_a"].shape
        idx = torch.cat([batch["pair_a"].reshape(-1, 2), batch["pair_b"].reshape(-1, 2),
                         batch["points"]], dim=0).long()
        feats = fea[idx[:, 0], idx[:, 1]]  # (2 G P + S, F)
        fa = feats[: g * p_].reshape(g, p_, -1)
        fb = feats[g * p_: 2 * g * p_].reshape(g, p_, -1)
        fea_loss = losses.contrastive_pairs_loss(fa, fb, batch["pair_valid"],
                                                 batch["group_valid"])
        lifted = mlp_apply(state["fea_up"], feats[2 * g * p_:])
        up_loss = losses.distillation_loss(lifted, batch["gt_clip"], batch["point_valid"])

    # every-10-step regularizers, multiplied in as the JAX package does
    reg_on = float(int(step) % 10 == 0)
    loss_dict = {
        "main_loss": main_loss,
        "feature_loss": fea_loss,
        "up_loss": up_loss,
        "depth_loss": depth_loss,
        "normal_loss": normal_l,
        "sh_reg": reg_on * losses.sh_reg(field.sh_coeffs, alive, field_sum),
        "scale_reg": reg_on * losses.scale_reg(field.log_scales, alive, cfg.max_gauss_ratio,
                                               field_sum),
    }
    if cfg.sky_alpha_reg > 0.0:
        # opt-in: rendered alpha on masked-out (free-space) pixels is pushed to zero
        inv = 1.0 - valid.to(rgb.dtype)
        loss_dict["sky_alpha_reg"] = cfg.sky_alpha_reg * (
            torch.sum(outs["alpha"] * inv) / torch.clamp(inv.sum(), min=1.0))
    total = sum(loss_dict.values())
    bins = outs["bins"]
    # pairs the stream budget B clipped; table bins have no stream, and the
    # tile-sharded bins report their band budget's clips as merge_overflow: 0
    pair_ovf = getattr(bins, "pair_overflow", None)
    if pair_ovf is None:
        pair_ovf = torch.zeros((), dtype=torch.int32, device=bins.overflow.device)
    aux = {
        "loss_dict": loss_dict,
        "psnr": losses.psnr(rgb, gt_img, valid),
        "radii": outs["proj"].radii,
        "overflow": bins.overflow,
        "dropped_tiles": bins.dropped_tiles,
        "pair_overflow": pair_ovf,
        "alpha": outs["alpha"],
    }
    # the tile-sharded compositor's gather stats, for the metrics
    for k in ("gathered_rows", "gather_overflow", "merge_overflow"):
        v = getattr(bins, k, None)
        if v is not None:
            aux[k] = v
    return total, aux


class GaussianSplatModel:
    """A config bundled with `render` and `train_loss` (the reference's Model
    class; the work is in the functions)."""

    def __init__(self, config: GaussianSplatConfig):
        self.config = config

    def render(self, field, alive, camera, step, **kw):
        return render(field, alive, camera, step, self.config, **kw)

    def train_loss(self, state, alive, camera, batch, step, **kw):
        return train_loss(state, alive, camera, batch, step, self.config, **kw)


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
