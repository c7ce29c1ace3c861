"""Losses and metrics (counterpart of the JAX package's models/losses.py):
masked L1 + SSIM on RGB, masked depth L1, normal MSE + cosine, the
SAM-mask contrastive feature loss, the CLIP distillation ("up") loss, the
SH and scale-ratio regularizers, and PSNR. The sampled pixel and point
index sets arrive as fixed-size tensors from the data layer."""

from __future__ import annotations

from typing import Optional

import torch

from gaussiangrasper_torch._device import full_f32


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
    as two banded matmuls in full float32 (see `full_f32`)."""
    bh = _band_matrix(img.shape[0], kernel)
    bw = _band_matrix(img.shape[1], kernel)
    with full_f32():
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


def contrastive_feature_loss(feature_map: torch.Tensor, pair_a: torch.Tensor, pair_b: torch.Tensor,
                             pair_valid: torch.Tensor, group_valid: torch.Tensor) -> torch.Tensor:
    """`contrastive_pairs_loss` at (row, col) pixel pairs (G, P, 2) of an
    (H, W, F) feature map."""
    fa = feature_map[pair_a[..., 0].long(), pair_a[..., 1].long()]
    fb = feature_map[pair_b[..., 0].long(), pair_b[..., 1].long()]
    return contrastive_pairs_loss(fa, fb, pair_valid, group_valid)


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
