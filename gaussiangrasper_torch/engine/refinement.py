"""Adaptive densification and culling at fixed capacity (counterpart of
the JAX package's engine/refinement.py).

The field owns `capacity` slots and `alive` marks the real Gaussians:
culling clears mask bits, split and duplicate children are written into
dead slots found by a prefix-sum free list (searchsorted maps each dead
slot back to its parent), and the Adam moments of reused slots are zeroed
as they are written. Decisions follow the reference's `refinement_after`:
split and dup masks, the 0.5 * max(H, W) gradient normalization, the /1.6
scale shrink of split parents and children, the cull thresholds and the
reset cool-down, and the periodic opacity reset to logit(0.8 *
cull_alpha_thresh) with zeroed opacity moments. The split noise is an
argument, so a test can hand both packages the same draws.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from gaussiangrasper_torch.core.transforms import normalize, quat_to_rotmat
from gaussiangrasper_torch.engine.optimizers import FIELD_GROUP_OF
from gaussiangrasper_torch.models.gaussian_field import GaussianParams


class DensifyStats(NamedTuple):
    """Running screen-space statistics, all capacity-length float32."""

    grad_norm_sum: torch.Tensor  # sum of ||dL/dxy|| over the steps seen
    vis_counts: torch.Tensor     # number of steps the Gaussian was visible
    max_radii: torch.Tensor      # max screen radius / max(W, H)

    @classmethod
    def zeros(cls, capacity: int, device=None) -> "DensifyStats":
        return cls(*(torch.zeros(capacity, dtype=torch.float32, device=device) for _ in range(3)))


def accumulate_stats(stats: DensifyStats, xy_grads: torch.Tensor, radii: torch.Tensor,
                     width: int, height: int, first: Optional[torch.Tensor] = None) -> DensifyStats:
    """Per-step update. The first accumulation after a reset (an all-zero
    counter) sets vis_counts to ones for every Gaussian and grad_norm_sum
    to the raw norms; later steps add only where the Gaussian is visible.
    `first`: that test taken over the whole field, where `stats` holds a
    shard of it (default: over `stats`)."""
    vis = (radii > 0.0).to(torch.float32)
    gn = torch.linalg.vector_norm(xy_grads, dim=-1)
    if first is None:
        first = stats.vis_counts.sum() == 0.0
    return DensifyStats(
        grad_norm_sum=torch.where(first, gn, stats.grad_norm_sum + gn * vis),
        vis_counts=torch.where(first, torch.ones_like(vis), stats.vis_counts + vis),
        max_radii=torch.maximum(stats.max_radii, vis * radii / float(max(width, height))),
    )


def _alloc_children(dead: torch.Tensor, n_children: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Free-list allocation. Per slot d: receives (d gets a child) and src
    (its parent slot). Children beyond the free slots are dropped."""
    c = dead.shape[0]
    dead_rank = torch.cumsum(dead.to(torch.int64), 0) - 1
    cum_incl = torch.cumsum(n_children.to(torch.int64), 0)
    receives = dead & (dead_rank < cum_incl[-1])
    r = torch.where(receives, dead_rank, torch.zeros_like(dead_rank))
    return receives, torch.clamp(torch.searchsorted(cum_incl, r, right=True), max=c - 1)


def refine(
    field: GaussianParams,
    alive: torch.Tensor,
    adam_groups: Dict[str, Tuple],
    stats: DensifyStats,
    step: int,
    noise: torch.Tensor,
    *,
    width: int,
    height: int,
    num_train_data: int,
    warmup_length: int = 500,
    refine_every: int = 100,
    reset_alpha_every: int = 30,
    densify_grad_thresh: float = 0.0002,
    densify_size_thresh: float = 0.01,
    n_split_samples: int = 2,
    stop_split_at: int = 15000,
    stop_screen_size_at: int = 4000,
    split_screen_size: float = 0.05,
    cull_alpha_thresh: float = 0.1,
    cull_scale_thresh: float = 0.5,
    cull_screen_size: float = 0.15,
):
    """One refinement pass. `adam_groups` maps a group name to its (mu, nu)
    moments; `noise` (capacity, 3) is the standard-normal split offset drawn
    per destination slot. Returns (field, alive, adam_groups, stats); the
    inputs are not modified."""
    c = field.capacity
    reset_interval = reset_alpha_every * refine_every
    past_warmup = step >= warmup_length
    cooled = (step % reset_interval) > (num_train_data + refine_every)

    scales = torch.exp(field.log_scales)
    scale_max = torch.amax(scales, dim=-1)

    avg_grad = (stats.grad_norm_sum / torch.clamp(stats.vis_counts, min=1.0)) \
        * 0.5 * float(max(width, height))
    high_grads = avg_grad > densify_grad_thresh
    splits = scale_max > densify_size_thresh
    if step < stop_screen_size_at:
        splits = splits | (stats.max_radii > split_screen_size)
    splits = splits & high_grads & alive
    dups = (scale_max <= densify_size_thresh) & high_grads & alive
    densify_on = past_warmup and step < stop_split_at and cooled
    splits = splits & densify_on
    dups = dups & densify_on

    n_children = torch.where(splits, n_split_samples, 0) + dups.to(torch.int64)
    receives, src = _alloc_children(~alive, n_children)

    src_is_split = splits[src]
    rot = quat_to_rotmat(normalize(field.quats[src]))
    offset = torch.einsum("nij,nj->ni", rot, scales[src] * noise)
    zero = torch.zeros((), dtype=field.means.dtype, device=field.means.device)
    child_means = field.means[src] + torch.where(src_is_split[:, None], offset, zero)
    shrink = math.log(1.6)
    child_log_scales = field.log_scales[src] - torch.where(src_is_split[:, None], shrink, 0.0)

    def scatter(leaf, child_leaf):
        return torch.where(receives.reshape((c,) + (1,) * (leaf.ndim - 1)), child_leaf, leaf)

    new_field = GaussianParams(
        means=scatter(field.means, child_means),
        log_scales=scatter(field.log_scales, child_log_scales)
        - torch.where(splits[:, None], shrink, 0.0),  # split parents shrink too
        quats=scatter(field.quats, field.quats[src]),
        opacity_logits=scatter(field.opacity_logits, field.opacity_logits[src]),
        sh_coeffs=scatter(field.sh_coeffs, field.sh_coeffs[src]),
        features=scatter(field.features, field.features[src]),
    )
    new_alive = alive | receives

    # cull; fresh children enter with zeroed screen-size stats
    opac = torch.sigmoid(new_field.opacity_logits)
    new_scale_max = torch.amax(torch.exp(new_field.log_scales), dim=-1)
    max_radii_eff = torch.where(receives, 0.0, stats.max_radii)
    culls = opac < cull_alpha_thresh
    if step > refine_every * reset_alpha_every:
        culls = culls | (new_scale_max > cull_scale_thresh)
        if step < stop_screen_size_at:
            culls = culls | (max_radii_eff > cull_screen_size)
    if past_warmup and cooled:
        new_alive = new_alive & ~culls

    reset_on = past_warmup and (step % reset_interval) == refine_every
    if reset_on:
        reset_logit = math.log(0.8 * cull_alpha_thresh) - math.log1p(-0.8 * cull_alpha_thresh)
        new_field = new_field._replace(
            opacity_logits=torch.full_like(new_field.opacity_logits, reset_logit))

    def clean(name, leaf):
        out = torch.where(receives.reshape((c,) + (1,) * (leaf.ndim - 1)), 0.0, leaf)
        return torch.zeros_like(out) if name == "opacity" and reset_on else out

    # only the field groups' moments are per Gaussian: up_net's and
    # camera_opt's stay (the JAX package cleans camera_opt's too and raises
    # on their (num_cameras, 6) shape: ROADMAP.md, F6)
    field_groups = set(FIELD_GROUP_OF.values())
    new_adam = {name: (tuple(clean(name, x) for x in mu_nu) if name in field_groups else mu_nu)
                for name, mu_nu in adam_groups.items()}
    new_stats = DensifyStats.zeros(c, field.means.device) if past_warmup else stats
    return new_field, new_alive, new_adam, new_stats
