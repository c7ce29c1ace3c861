"""The served text query of the reference: the lift of a rendered feature
map to CLIP space and the LERF relevancy against a query and canonical
phrases.

Frozen copies from gaussiangrasper_torch at commit d90391f:
scripts/render.py (`lift`, on `mlp_apply`'s parameter dict) and
scripts/query.py (`relevancy_map`). Changed: no full_f32 block (the caller
sets the precision). Plain PyTorch; imports nothing of
gaussiangrasper_torch or JAX.
"""

from __future__ import annotations

from typing import Mapping

import torch

from .model import mlp_apply


def lift(fea_up: Mapping[str, torch.Tensor], feature: torch.Tensor) -> torch.Tensor:
    """(H, W, F) rendered features -> (H, W, 512) CLIP space."""
    with torch.no_grad():
        return mlp_apply(fea_up, feature.reshape(-1, feature.shape[-1])).reshape(
            feature.shape[0], feature.shape[1], -1)


def relevancy_map(clip_map: torch.Tensor, query: torch.Tensor,
                  canonical: torch.Tensor) -> torch.Tensor:
    """LERF relevancy of an (H, W, 512) map against a (512,) query and
    (K, 512) canonical phrases: min over canonicals of the pairwise softmax."""
    f = clip_map / (torch.linalg.vector_norm(clip_map, dim=-1, keepdim=True) + 1e-8)
    q = query / (torch.linalg.vector_norm(query) + 1e-8)
    c = canonical / (torch.linalg.vector_norm(canonical, dim=-1, keepdim=True) + 1e-8)
    pos = f @ q  # (H, W)
    negs = f @ c.T  # (H, W, K)
    pair = torch.exp(pos)[..., None] / (torch.exp(pos)[..., None] + torch.exp(negs))
    return pair.min(dim=-1).values
