"""The splat model of the reference: the field, the losses, the fea_up
MLP, render and the training loss.

Frozen copies from gaussiangrasper_torch at commit d90391f:
models/gaussian_field.py (GaussianParams, init_from_seeds and what it
needs), models/py, models/efd.py (mlp_apply) and models/model.py
(GaussianSplatConfig, smallest_axis_normals, active_sh_degree,
render_inputs, render, train_loss). Changed: no full_f32 blocks (the
caller sets the precision), no pose deltas, no compositor swap and no
sharded sums.
Plain PyTorch; imports nothing of gaussiangrasper_torch or JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .geometry import Camera, eval_sh, num_sh_bases, project_gaussians, quat_to_rotmat, random_quats, view_matrix
from .raster import RasterizeConfig, rasterize_projected

# --- from gaussiangrasper_torch/models/gaussian_field.py ---

SH_C0 = 0.28209479177387814


FIELD_KEYS = ("means", "log_scales", "quats", "opacity_logits", "sh_coeffs", "features")


def rgb_to_sh0(rgb):
    """RGB in [0, 1] -> 0th SH coefficient."""
    return (rgb - 0.5) / SH_C0


class GaussianParams(NamedTuple):
    means: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    opacity_logits: torch.Tensor
    sh_coeffs: torch.Tensor
    features: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    def to(self, device) -> "GaussianParams":
        return GaussianParams(*(x.to(device) for x in self))

    def pad_to(self, new_capacity: int) -> "GaussianParams":
        """Grow capacity (new slots are dead); quats pad with identity."""
        extra = new_capacity - self.capacity
        if extra <= 0:
            return self

        def pad(x):
            return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])

        ident = self.quats.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(extra, 4)
        return GaussianParams(
            means=pad(self.means), log_scales=pad(self.log_scales),
            quats=torch.cat([self.quats, ident]),
            opacity_logits=pad(self.opacity_logits),
            sh_coeffs=pad(self.sh_coeffs), features=pad(self.features),
        )


def knn_mean_distance(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean distance from each point to its k nearest other points
    (scipy's cKDTree; the JAX package uses scikit-learn's NearestNeighbors,
    which returns the same sorted distances)."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float64)
    distances, _ = cKDTree(pts).query(pts, k=k + 1)
    return distances[:, 1:].mean(axis=-1).astype(np.float32)


def init_from_seeds(
    seed_xyz: np.ndarray,
    seed_rgb: np.ndarray,
    draws: Dict[str, np.ndarray],
    *,
    sh_degree: int = 4,
    capacity: Optional[int] = None,
    init_opacity: float = 0.1,
    device=None,
) -> Tuple[GaussianParams, torch.Tensor]:
    """Initialize from SfM / RGB-D seed points, seed_rgb in [0, 255]: scales
    from the mean distance to the 3 nearest seeds, base colour from the
    seed colour, uniform quats and features from injected uniforms (see
    `seed_draws`). Returns (params, alive)."""
    n = seed_xyz.shape[0]
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} is below the {n} seed points")
    avg_dist = np.maximum(knn_mean_distance(seed_xyz), 1e-7)
    log_scales = torch.log(torch.as_tensor(avg_dist, device=device))[:, None].repeat(1, 3)
    shs = torch.zeros(n, num_sh_bases(sh_degree), 3, device=device)
    shs[:, 0, :] = rgb_to_sh0(torch.as_tensor(np.asarray(seed_rgb, np.float32), device=device) / 255.0)
    feats = torch.tensor(np.asarray(draws["features"], np.float32), device=device)
    params = GaussianParams(
        means=torch.as_tensor(np.asarray(seed_xyz, np.float32), device=device),
        log_scales=log_scales,
        quats=random_quats(torch.tensor(np.asarray(draws["quats"], np.float32), device=device)),
        opacity_logits=torch.full((n,), math.log(init_opacity / (1.0 - init_opacity)), device=device),
        sh_coeffs=shs,
        features=feats * 2.0 - 1.0,
    )
    return params.pad_to(cap), torch.arange(cap, device=device) < n

# --- from gaussiangrasper_torch/models/py ---

def safe_norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12, keepdim: bool = True):
    """L2 norm with a finite gradient at x == 0."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def _gaussian_kernel1d(size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def _band_matrix(n: int, kernel: torch.Tensor) -> torch.Tensor:
    """(n, n-k+1) banded B with B[i, o] = kernel[i - o]: x @ B is a
    valid-padding 1-D correlation along that axis."""
    k = kernel.shape[0]
    d = (torch.arange(n, device=kernel.device)[:, None]
         - torch.arange(n - k + 1, device=kernel.device)[None, :])
    inside = (d >= 0) & (d < k)
    return torch.where(inside, kernel[torch.clamp(d, 0, k - 1)], torch.zeros((), device=kernel.device))


def _blur_valid(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable gaussian blur with valid padding, (H, W, C) -> (H', W', C),
    as two banded matmuls."""
    bh = _band_matrix(img.shape[0], kernel)
    bw = _band_matrix(img.shape[1], kernel)
    x = img.permute(2, 0, 1)  # (C, H, W)
    x = bh.T @ x @ bw
    return x.permute(1, 2, 0)


def ssim(img0: torch.Tensor, img1: torch.Tensor, *, data_range: float = 1.0,
         win_size: int = 11, sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM between two (H, W, C) images (pytorch_msssim semantics:
    gaussian window 11 / 1.5, valid padding)."""
    kernel = _gaussian_kernel1d(win_size, sigma, device=img0.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu0 = _blur_valid(img0, kernel)
    mu1 = _blur_valid(img1, kernel)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = _blur_valid(img0 * img0, kernel) - mu00
    s11 = _blur_valid(img1 * img1, kernel) - mu11
    s01 = _blur_valid(img0 * img1, kernel) - mu01
    cs = (2.0 * s01 + c2) / (s00 + s11 + c2)
    return torch.mean(((2.0 * mu01 + c1) / (mu00 + mu11 + c1)) * cs)


def _mask_like(mask: torch.Tensor, pred: torch.Tensor):
    """Mask broadcast to pred's rank and the count of selected elements
    (torch's masked-mean denominator)."""
    m = mask.to(pred.dtype)
    while m.ndim < pred.ndim:
        m = m[..., None]
    n_el = torch.clamp(m.sum() * (pred.shape[-1] if m.shape[-1] == 1 else 1), min=1.0)
    return m, n_el


def masked_l1(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean |pred - gt| over mask-true pixels; mask (H, W)."""
    m, n_el = _mask_like(mask, pred)
    return torch.sum(torch.abs(pred - gt) * m) / n_el


def masked_mse(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m, n_el = _mask_like(mask, pred)
    return torch.sum((pred - gt) ** 2 * m) / n_el


def cosine_similarity_loss(a: torch.Tensor, b: torch.Tensor,
                           weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1 - mean cosine similarity along the last axis; optional row weights."""
    sim = torch.sum((a / safe_norm(a)) * (b / safe_norm(b)), dim=-1)
    if weights is None:
        return 1.0 - sim.mean()
    w = weights.to(sim.dtype)
    return 1.0 - torch.sum(sim * w) / torch.clamp(w.sum(), min=1.0)


def normal_loss(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """0.5 * masked MSE + 0.5 * masked cosine loss."""
    cos = cosine_similarity_loss(pred.reshape(-1, 3), gt.reshape(-1, 3), weights=mask.reshape(-1))
    return 0.5 * masked_mse(pred, gt, mask) + 0.5 * cos


def contrastive_pairs_loss(fa: torch.Tensor, fb: torch.Tensor, pair_valid: torch.Tensor,
                           group_valid: torch.Tensor) -> torch.Tensor:
    """Contrastive loss on gathered pair features fa, fb (G, P, F): per
    SAM-mask group, 1 - mean cos(fa, fb) over valid pairs; averaged over
    valid groups."""
    sim = torch.sum((fa / safe_norm(fa)) * (fb / safe_norm(fb)), dim=-1)  # (G, P)
    pv = pair_valid.to(sim.dtype)
    per_group = 1.0 - torch.sum(sim * pv, dim=-1) / torch.clamp(pv.sum(-1), min=1.0)
    gv = group_valid.to(sim.dtype)
    return torch.sum(per_group * gv) / torch.clamp(gv.sum(), min=1.0)


def distillation_loss(lifted: torch.Tensor, gt_clip: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """CLIP-space cosine distillation ("up_loss") over valid points (S, 512)."""
    return cosine_similarity_loss(lifted, gt_clip, weights=valid)


def _sum_count(total: torch.Tensor, count: torch.Tensor, reduce):
    """(sum, count) over the whole field: `reduce` sums the (2,) pair
    across the shards of a sharded field (None: the field is whole)."""
    return (total, count) if reduce is None else tuple(reduce(torch.stack([total, count])))


def sh_reg(sh_coeffs: torch.Tensor, alive: torch.Tensor, reduce=None) -> torch.Tensor:
    """Mean L2 norm of the rest-band SH coefficients over alive Gaussians."""
    norms = safe_norm(sh_coeffs[:, 1:, :], dim=1, keepdim=False)  # (N, 3)
    a = alive.to(norms.dtype)[:, None]
    total, count = _sum_count(torch.sum(norms * a), a.sum() * 3.0, reduce)
    return total / torch.clamp(count, min=1.0)


def scale_reg(log_scales: torch.Tensor, alive: torch.Tensor, max_gauss_ratio: float = 10.0,
              reduce=None) -> torch.Tensor:
    """Anisotropy regularizer: 0.1 * mean over alive Gaussians of
    max(scale ratio, r) - r. amax/amin share the gradient among ties, as
    JAX's max/min reductions do."""
    s = torch.exp(log_scales)
    ratio = torch.amax(s, dim=-1) / torch.clamp(torch.amin(s, dim=-1), min=1e-12)
    penalty = torch.clamp(ratio, min=max_gauss_ratio) - max_gauss_ratio
    a = alive.to(penalty.dtype)
    total, count = _sum_count(torch.sum(penalty * a), a.sum(), reduce)
    return 0.1 * total / torch.clamp(count, min=1.0)


def psnr(pred: torch.Tensor, gt: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2) if mask is None else masked_mse(pred, gt, mask)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))

# --- from gaussiangrasper_torch/models/efd.py ---

def mlp_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """`FeaUp.forward` on a dict of its state (`layers.{i}.weight` (d_out,
    d_in) and `layers.{i}.bias`), so gradients reach plain tensors."""
    n = len(params) // 2
    for i in range(n):
        x = torch.nn.functional.linear(x, params[f"layers.{i}.weight"],
                                       params[f"layers.{i}.bias"])
        if i < n - 1:
            x = torch.relu(x)
    return x

# --- from gaussiangrasper_torch/models/model.py ---

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
    pose_opt_mode: str = "off"  # the reference runs "off" only
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
    viewdirs = viewdirs / safe_norm(viewdirs)
    rgbs = torch.clamp(
        eval_sh(active_sh_degree(step, cfg), viewdirs, field.sh_coeffs) + 0.5, 0.0, 1.0)
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
) -> Dict[str, Any]:
    """Render rgb / feature / depth / normal maps for one camera. Returns
    per-channel images, alpha, the projection and the binning stats."""
    F = cfg.feature_dim
    proj, colors, opac, bg = render_inputs(field, alive, camera, step, cfg, crop_mask, probe)
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


def train_loss(
    state: Dict[str, Any],
    alive: torch.Tensor,
    camera: Camera,
    batch: Dict[str, torch.Tensor],
    step: int,
    cfg: GaussianSplatConfig,
    probe: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Total training loss and aux outputs. `state` holds "field"
    (GaussianParams) and "fea_up" (`mlp_apply` params).

    batch: image (H, W, 3), depth (H, W), normal (H, W, 3), valid_mask
    (H, W) bool, pair_a / pair_b (G, P, 2) int (row, col), pair_valid
    (G, P), group_valid (G,), points (S, 2) int, point_valid (S,),
    gt_clip (S, 512)."""
    field: GaussianParams = state["field"]
    outs = render(field, alive, camera, step, cfg, probe=probe)

    gt_img = batch["image"]
    valid = batch["valid_mask"]
    depth_gt = batch["depth"]
    depth_mask = (depth_gt > 0.05) & valid
    gt_normal = batch["normal"] / safe_norm(batch["normal"])

    rgb = outs["rgb"]
    l1 = masked_l1(rgb, gt_img, valid)
    vm3 = valid[..., None].to(rgb.dtype)
    sim = 1.0 - ssim(gt_img * vm3, rgb * vm3)
    main_loss = (1.0 - cfg.ssim_lambda) * l1 + cfg.ssim_lambda * sim
    depth_loss = masked_l1(outs["depth"][..., 0], depth_gt, depth_mask)
    normal_l = normal_loss(outs["normal"], gt_normal, depth_mask)

    # one fused pixel gather for pair_a, pair_b and the distillation points
    fea = outs["feature"]
    g, p_, _ = batch["pair_a"].shape
    idx = torch.cat([batch["pair_a"].reshape(-1, 2), batch["pair_b"].reshape(-1, 2),
                     batch["points"]], dim=0).long()
    feats = fea[idx[:, 0], idx[:, 1]]  # (2 G P + S, F)
    fa = feats[: g * p_].reshape(g, p_, -1)
    fb = feats[g * p_: 2 * g * p_].reshape(g, p_, -1)
    fea_loss = contrastive_pairs_loss(fa, fb, batch["pair_valid"], batch["group_valid"])
    lifted = mlp_apply(state["fea_up"], feats[2 * g * p_:])
    up_loss = distillation_loss(lifted, batch["gt_clip"], batch["point_valid"])

    # every-10-step regularizers, multiplied in as the JAX package does
    reg_on = float(int(step) % 10 == 0)
    loss_dict = {
        "main_loss": main_loss,
        "feature_loss": fea_loss,
        "up_loss": up_loss,
        "depth_loss": depth_loss,
        "normal_loss": normal_l,
        "sh_reg": reg_on * sh_reg(field.sh_coeffs, alive),
        "scale_reg": reg_on * scale_reg(field.log_scales, alive, cfg.max_gauss_ratio),
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
        "psnr": psnr(rgb, gt_img, valid),
        "radii": outs["proj"].radii,
        "overflow": bins.overflow,
        "dropped_tiles": bins.dropped_tiles,
        "pair_overflow": pair_ovf,
        "alpha": outs["alpha"],
    }
    return total, aux

