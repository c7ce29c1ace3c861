"""Evaluation losses and metrics (counterpart of the eval subset of
the JAX package's models/losses.py): safe_norm, SSIM, masked L1/MSE,
cosine similarity and PSNR. The training losses come with the training
slice."""

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


def psnr(pred: torch.Tensor, gt: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2) if mask is None else masked_mse(pred, gt, mask)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
