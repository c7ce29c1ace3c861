"""Per-group Adam with learning-rate schedules and gradient accumulation
(counterpart of the JAX package's engine/optimizers.py).

Adam is written out with optax's `scale_by_adam` semantics: b1 0.9, b2
0.999, eps 1e-15 added outside the square root, bias correction by the
incremented count. Gradients are *summed* into a per-group accumulator and
consumed on due steps (step % accum == accum - 1), when the count
advances and the accumulator resets. The moments live in plain tensors
beside the parameters (not `torch.optim.Adam`) because refinement rewrites
them row by row. The `up_net` group is the `fea_up` MLP in
`FeaUp.state_dict()` layout, so its weights and moments are the JAX
package's transposed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from gaussiangrasper_torch.models.gaussian_field import GaussianParams


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

B1, B2 = 0.9, 0.999


def lr_at(cfg: GroupConfig, step: int) -> torch.Tensor:
    """Exponential interpolation lr_init -> lr_final over max_steps, in
    float32 as the JAX package computes it; a 0-d CPU tensor."""
    f32 = torch.float32
    if cfg.lr_final is None:
        return torch.tensor(cfg.lr_init, dtype=f32)
    t = torch.clamp(torch.tensor(step, dtype=f32) / cfg.max_steps, 0.0, 1.0)
    return torch.exp((1.0 - t) * torch.log(torch.tensor(cfg.lr_init, dtype=f32))
                     + t * torch.log(torch.tensor(cfg.lr_final, dtype=f32)))


# --- the reference's other scheduler family (engine/schedulers.py), in
# float32 as the JAX package computes it; each a 0-d CPU tensor ---


def exponential_decay_lr(step, lr_init: float, lr_final: float, max_steps: int,
                         warmup_steps: int = 0, lr_pre_warmup: float = 1e-8,
                         ramp: str = "cosine") -> torch.Tensor:
    """ExponentialDecayScheduler with its pre-warmup ramp (cosine or linear)."""
    f32 = torch.float32
    step = torch.tensor(step, dtype=f32)
    if warmup_steps > 0:
        frac = torch.clamp(step / warmup_steps, 0.0, 1.0)
        ramp_of = torch.sin(0.5 * torch.pi * frac) if ramp == "cosine" else frac
        warm = lr_pre_warmup + (lr_init - lr_pre_warmup) * ramp_of
    else:
        warm = torch.tensor(lr_init, dtype=f32)
    t = torch.clamp((step - warmup_steps) / max(max_steps - warmup_steps, 1), 0.0, 1.0)
    decayed = torch.exp((1.0 - t) * torch.log(torch.tensor(lr_init, dtype=f32))
                        + t * torch.log(torch.tensor(lr_final, dtype=f32)))
    return torch.where(step < warmup_steps, warm, decayed)


def multistep_lr(step, lr_init: float, milestones=(500_000, 750_000, 900_000),
                 gamma: float = 0.33) -> torch.Tensor:
    """MultiStepScheduler: lr_init times gamma per milestone passed."""
    n = sum(int(step >= m) for m in milestones)
    return lr_init * torch.tensor(gamma, dtype=torch.float32) ** float(n)


def cosine_decay_lr(step, lr_init: float, max_steps: int, warmup_steps: int = 0,
                    lr_final: float = 0.0) -> torch.Tensor:
    """CosineDecayScheduler with a linear warmup."""
    step = torch.tensor(step, dtype=torch.float32)
    warm = lr_init * step / max(warmup_steps, 1)
    t = torch.clamp((step - warmup_steps) / max(max_steps - warmup_steps, 1), 0.0, 1.0)
    cos = lr_final + 0.5 * (lr_init - lr_final) * (1.0 + torch.cos(torch.pi * t))
    return torch.where(step < warmup_steps, warm, cos)


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

