"""Proposal-network sampling losses, the nerfacto / mip-NeRF 360 machinery
(counterpart of the JAX package's models/proposal.py)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def outer_weights(t_env: torch.Tensor, w_env: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """For each query interval of t (..., S+1), the total proposal weight
    w_env (..., Sp) of the proposal bins t_env (..., Sp+1) it overlaps:
    (..., S). Interval starts search on the left side, ends on the right."""
    cw = torch.cat([torch.zeros_like(w_env[..., :1]), torch.cumsum(w_env, dim=-1)], dim=-1)
    flat_env = t_env.reshape(-1, t_env.shape[-1]).contiguous()
    flat_cw = cw.reshape(-1, cw.shape[-1])
    flat_t = t.reshape(-1, t.shape[-1])
    last = flat_cw.shape[-1] - 1
    lo = torch.searchsorted(flat_env, flat_t[:, :-1].contiguous(), right=False)
    hi = torch.searchsorted(flat_env, flat_t[:, 1:].contiguous(), right=True)
    lo = torch.clamp(lo - 1, 0, last)
    hi = torch.clamp(hi, 0, last)
    out = torch.gather(flat_cw, 1, hi) - torch.gather(flat_cw, 1, lo)
    return out.reshape(tuple(t.shape[:-1]) + (t.shape[-1] - 1,))


def interlevel_loss(prop_hists: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Sum over proposal levels of mean(clip(w - w_outer, 0)^2 / (w + eps)).
    The final edges t and weights w are detached: only the proposals move."""
    t = t.detach()
    w = w.detach()
    total = 0.0
    for t_env, w_env in prop_hists:
        w_outer = outer_weights(t_env, w_env, t)
        excess = torch.clamp(w - w_outer, min=0.0)
        total = total + torch.mean(excess * excess / (w + 1e-7))
    return total


def distortion_loss(t: torch.Tensor, w: torch.Tensor, near: float, far: float) -> torch.Tensor:
    """The mip-NeRF 360 distortion loss over edges normalized to [0, 1]."""
    s = (t - near) / (far - near)
    mids = 0.5 * (s[..., 1:] + s[..., :-1])
    dm = torch.abs(mids[..., :, None] - mids[..., None, :])
    inter = torch.sum(w[..., :, None] * w[..., None, :] * dm, dim=(-2, -1))
    intra = torch.sum(w * w * (s[..., 1:] - s[..., :-1]), dim=-1) / 3.0
    return torch.mean(inter + intra)
