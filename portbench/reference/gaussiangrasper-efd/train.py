"""Training of the splat reference: grouped Adam with accumulation, the
densify statistics and refine, the train and refine steps.

Frozen copies from gaussiangrasper_torch at commit d90391f:
engine/optimizers.py (GroupConfig, DEFAULT_GROUPS, FIELD_GROUP_OF, lr_at,
tree_map, leaves, GroupOptState, to_groups, from_groups, init_opt_state,
_adam, apply_updates_grouped, global_norm), engine/refinement.py and
engine/train_state.py (TrainState, init_train_state, grow_capacity,
train_step, refine_step). Changed: no pose deltas.
Plain PyTorch; imports nothing of gaussiangrasper_torch or JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .geometry import normalize, quat_to_rotmat
from .model import GaussianParams, GaussianSplatConfig, train_loss

B1, B2 = 0.9, 0.999


# --- from gaussiangrasper_torch/engine/optimizers.py ---

@dataclasses.dataclass(frozen=True)
class GroupConfig:
    lr_init: float
    lr_final: Optional[float] = None  # None => constant lr
    max_steps: int = 30000
    eps: float = 1e-15
    accum: int = 1  # gradient accumulation period


DEFAULT_GROUPS: Dict[str, GroupConfig] = {
    "xyz": GroupConfig(1.6e-4, 1.6e-6, accum=10),
    "color": GroupConfig(5e-4, 1e-4, accum=10),
    "feature": GroupConfig(5e-4, 1e-4, accum=10),
    "opacity": GroupConfig(0.05),
    "scaling": GroupConfig(5e-3, 1e-3),
    "rotation": GroupConfig(1e-3),
    "up_net": GroupConfig(1e-3, 5e-5),
    "camera_opt": GroupConfig(6e-4, 6e-5, accum=100),
}


FIELD_GROUP_OF = {
    "means": "xyz",
    "sh_coeffs": "color",
    "features": "feature",
    "opacity_logits": "opacity",
    "log_scales": "scaling",
    "quats": "rotation",
}


def lr_at(cfg: GroupConfig, step: int) -> torch.Tensor:
    """Exponential interpolation lr_init -> lr_final over max_steps, in
    float32 as the JAX package computes it; a 0-d CPU tensor."""
    f32 = torch.float32
    if cfg.lr_final is None:
        return torch.tensor(cfg.lr_init, dtype=f32)
    t = torch.clamp(torch.tensor(step, dtype=f32) / cfg.max_steps, 0.0, 1.0)
    return torch.exp((1.0 - t) * torch.log(torch.tensor(cfg.lr_init, dtype=f32))
                     + t * torch.log(torch.tensor(cfg.lr_final, dtype=f32)))


def tree_map(fn: Callable, *trees):
    """`fn` over a tensor, or over the values of dicts with one key set."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree) -> list:
    return list(tree.values()) if isinstance(tree, dict) else [tree]


class GroupOptState(NamedTuple):
    mu: Any      # first moments, the group's structure
    nu: Any      # second moments
    count: torch.Tensor  # () int32 Adam steps taken
    accum: Any   # summed gradients since the last update


def to_groups(state: Dict[str, Any]) -> Dict[str, Any]:
    """{'field': GaussianParams, 'fea_up': dict, optional 'pose':
    (num_cameras, 6) deltas} -> the named parameter groups."""
    field = state["field"]
    groups = {g: getattr(field, leaf) for leaf, g in FIELD_GROUP_OF.items()}
    groups["up_net"] = state["fea_up"]
    if state.get("pose") is not None:
        groups["camera_opt"] = state["pose"]
    return groups


def from_groups(groups: Dict[str, Any], template: Dict[str, Any]) -> Dict[str, Any]:
    field: GaussianParams = template["field"]._replace(
        **{leaf: groups[g] for leaf, g in FIELD_GROUP_OF.items()})
    out = {"field": field, "fea_up": groups["up_net"]}
    if "camera_opt" in groups:
        out["pose"] = groups["camera_opt"]
    return out


def init_opt_state(state: Dict[str, Any],
                   group_cfgs: Dict[str, GroupConfig] = DEFAULT_GROUPS) -> Dict[str, GroupOptState]:
    out = {}
    for name, params in to_groups(state).items():
        if name not in group_cfgs:
            raise KeyError(f"no optimizer config for group {name!r}")
        zeros = lambda: tree_map(torch.zeros_like, params)  # noqa: E731
        dev = leaves(params)[0].device
        out[name] = GroupOptState(mu=zeros(), nu=zeros(), accum=zeros(),
                                  count=torch.zeros((), dtype=torch.int32, device=dev))
    return out


def _adam(g, mu, nu, count, eps: float):
    """optax.scale_by_adam on one group: (update, mu, nu, count)."""
    mu = tree_map(lambda g_, m: (1.0 - B1) * g_ + B1 * m, g, mu)
    nu = tree_map(lambda g_, v: (1.0 - B2) * (g_ * g_) + B2 * v, g, nu)
    count = count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(B1, dtype=torch.float32, device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.tensor(B2, dtype=torch.float32, device=c.device), c)
    upd = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps), mu, nu)
    return upd, mu, nu, count


def apply_updates_grouped(
    state: Dict[str, Any],
    grads: Dict[str, Any],
    opt_state: Dict[str, GroupOptState],
    step: int,
    group_cfgs: Dict[str, GroupConfig] = DEFAULT_GROUPS,
):
    """One optimizer step; `grads` has the structure of `state`. Returns
    (new state, new optimizer state); the inputs are not modified."""
    param_groups = to_groups(state)
    grad_groups = to_groups(grads)
    new_params, new_opt = {}, {}
    with torch.no_grad():
        for name, params in param_groups.items():
            cfg = group_cfgs[name]
            st = opt_state[name]
            g_sum = tree_map(torch.add, st.accum, grad_groups[name])
            if cfg.accum == 1 or step % cfg.accum == cfg.accum - 1:
                lr = lr_at(cfg, step).to(leaves(params)[0].device)
                upd, mu, nu, count = _adam(g_sum, st.mu, st.nu, st.count, cfg.eps)
                new_params[name] = tree_map(lambda p, u: p + (-lr * u), params, upd)
                new_opt[name] = GroupOptState(mu, nu, count, tree_map(torch.zeros_like, g_sum))
            else:
                new_params[name] = params
                new_opt[name] = st._replace(accum=g_sum)
    return from_groups(new_params, state), new_opt


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor of a group."""
    return torch.sqrt(sum(torch.sum(x * x) for x in leaves(tree)))

# --- from gaussiangrasper_torch/engine/refinement.py ---

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

# --- from gaussiangrasper_torch/engine/train_state.py ---

@dataclasses.dataclass
class TrainState:
    step: int
    field: GaussianParams                   # capacity-length parameter buffers
    alive: torch.Tensor                     # (capacity,) bool
    fea_up: Dict[str, torch.Tensor]         # `mlp_apply` params (FeaUp.state_dict layout)
    opt: Dict[str, GroupOptState]     # per-group Adam moments, count, accumulator
    stats: DensifyStats
    generator: torch.Generator              # draws the split noise of refine_step
    pose: Optional[torch.Tensor] = None     # (num_cameras, 6) pose deltas, or None

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()


def init_train_state(field: GaussianParams, alive: torch.Tensor, fea_up: Dict[str, torch.Tensor],
                     group_cfgs: Dict[str, GroupConfig] = DEFAULT_GROUPS,
                     seed: int = 0, pose: Optional[torch.Tensor] = None) -> TrainState:
    """`pose`: (num_cameras, 6) deltas, trained in the "camera_opt" group."""
    dev = field.means.device
    return TrainState(
        step=0, field=field, alive=alive, fea_up=dict(fea_up),
        opt=init_opt_state({"field": field, "fea_up": fea_up, "pose": pose}, group_cfgs),
        stats=DensifyStats.zeros(field.capacity, dev),
        generator=torch.Generator(device=dev).manual_seed(seed),
        pose=pose,
    )


def grow_capacity(state: TrainState, new_capacity: int) -> TrainState:
    """Pad every capacity-length buffer to `new_capacity`: field rows (dead,
    identity quats), alive (False), the field groups' moments and
    accumulators (zeros) and the densify stats (zeros)."""
    c = state.field.capacity
    if new_capacity <= c:
        return state
    extra = new_capacity - c

    def pad(x):
        return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])

    field_groups = set(FIELD_GROUP_OF.values())
    opt = {name: (st._replace(mu=pad(st.mu), nu=pad(st.nu), accum=pad(st.accum))
                  if name in field_groups else st)
           for name, st in state.opt.items()}
    return dataclasses.replace(
        state, field=state.field.pad_to(new_capacity), alive=pad(state.alive), opt=opt,
        stats=DensifyStats(*(pad(x) for x in state.stats)))


def train_step(state: TrainState, camera: Camera, batch: Dict[str, torch.Tensor],
               cfg: GaussianSplatConfig,
               group_cfgs: Dict[str, GroupConfig] = DEFAULT_GROUPS,
               ) -> Tuple[TrainState, Dict[str, Any]]:
    """One optimization step. Returns (new state, metrics); the metrics
    are device tensors (no host sync)."""
    field = GaussianParams(*(x.detach().requires_grad_(True) for x in state.field))
    fea_up = {k: v.detach().requires_grad_(True) for k, v in state.fea_up.items()}
    pose = None if state.pose is None else state.pose.detach().requires_grad_(True)
    probe = torch.zeros(state.field.capacity, 2, dtype=field.means.dtype,
                        device=field.means.device, requires_grad=True)
    model_state = {"field": field, "fea_up": fea_up, "pose": pose}
    total, aux = train_loss(model_state, state.alive, camera, batch, state.step, cfg, probe=probe)

    extra = [probe] if pose is None else [pose, probe]
    leaves = list(field) + list(fea_up.values()) + extra
    grad_list = torch.autograd.grad(total, leaves, allow_unused=True)
    grad_list = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grad_list)]
    n_field, n_fea = len(field), len(fea_up)
    grads = {"field": GaussianParams(*grad_list[:n_field]),
             "fea_up": dict(zip(fea_up, grad_list[n_field:n_field + n_fea])),
             "pose": None if pose is None else grad_list[-2]}
    probe_grad = grad_list[-1]

    stats = accumulate_stats(state.stats, probe_grad, aux["radii"].detach(),
                             camera.width, camera.height)
    new_model, new_opt = apply_updates_grouped(
        {"field": state.field, "fea_up": state.fea_up, "pose": state.pose}, grads, state.opt,
        state.step, group_cfgs)

    metrics = {
        "loss": total.detach(),
        "psnr": aux["psnr"].detach(),
        "gaussian_count": state.num_alive,
        "overflow": aux["overflow"],
        "dropped_tiles": aux["dropped_tiles"],
        "pair_overflow": aux["pair_overflow"],
        **{k: v.detach() for k, v in aux["loss_dict"].items()},
        **{f"grad_norm/{name}": global_norm(g)
           for name, g in to_groups(grads).items()},
    }
    new_state = dataclasses.replace(state, step=state.step + 1, field=new_model["field"],
                                    fea_up=new_model["fea_up"], opt=new_opt, stats=stats,
                                    pose=new_model.get("pose"))
    return new_state, metrics


def refine_step(state: TrainState, cfg: GaussianSplatConfig, width: int, height: int,
                num_train_data: int, noise: Optional[torch.Tensor] = None) -> TrainState:
    """Densify / cull / reset pass. `noise` (capacity, 3) standard normals
    for the split offsets; drawn from `state.generator` when omitted."""
    if noise is None:
        noise = torch.randn(state.field.capacity, 3, generator=state.generator,
                            device=state.field.means.device)
    adam_groups = {name: (st.mu, st.nu) for name, st in state.opt.items()}
    field, alive, adam_groups, stats = refine(
        state.field, state.alive, adam_groups, state.stats, state.step, noise,
        width=width, height=height, num_train_data=num_train_data,
        warmup_length=cfg.warmup_length, refine_every=cfg.refine_every,
        reset_alpha_every=cfg.reset_alpha_every, densify_grad_thresh=cfg.densify_grad_thresh,
        densify_size_thresh=cfg.densify_size_thresh, n_split_samples=cfg.n_split_samples,
        stop_split_at=cfg.stop_split_at, stop_screen_size_at=cfg.stop_screen_size_at,
        split_screen_size=cfg.split_screen_size, cull_alpha_thresh=cfg.cull_alpha_thresh,
        cull_scale_thresh=cfg.cull_scale_thresh, cull_screen_size=cfg.cull_screen_size,
    )
    opt = {name: st._replace(mu=adam_groups[name][0], nu=adam_groups[name][1])
           for name, st in state.opt.items()}
    return dataclasses.replace(state, field=field, alive=alive, opt=opt, stats=stats)

