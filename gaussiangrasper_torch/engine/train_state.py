"""Training state, the train step and the refine step (counterpart of the
JAX package's engine/train_state.py).

`train_step` runs the whole iteration eagerly: loss, gradients of every
parameter group and of the screen-space probe in one backward (the probe's
gradient feeds the densification statistics), then the grouped Adam
update with accumulation. `refine_step` is the densify / cull / reset pass
the host loop calls every `refine_every` steps. Both return a new state
and leave their input's tensors untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from gaussiangrasper_torch.core.cameras import Camera
from gaussiangrasper_torch.engine import optimizers as optim
from gaussiangrasper_torch.engine.refinement import DensifyStats, accumulate_stats, refine
from gaussiangrasper_torch.models.gaussian_field import GaussianParams
from gaussiangrasper_torch.models.model import GaussianSplatConfig, train_loss


@dataclasses.dataclass
class TrainState:
    step: int
    field: GaussianParams                   # capacity-length parameter buffers
    alive: torch.Tensor                     # (capacity,) bool
    fea_up: Dict[str, torch.Tensor]         # `mlp_apply` params (FeaUp.state_dict layout)
    opt: Dict[str, optim.GroupOptState]     # per-group Adam moments, count, accumulator
    stats: DensifyStats
    generator: torch.Generator              # draws the split noise of refine_step

    @property
    def num_alive(self) -> torch.Tensor:
        return self.alive.sum()


def init_train_state(field: GaussianParams, alive: torch.Tensor, fea_up: Dict[str, torch.Tensor],
                     group_cfgs: Dict[str, optim.GroupConfig] = optim.DEFAULT_GROUPS,
                     seed: int = 0) -> TrainState:
    dev = field.means.device
    return TrainState(
        step=0, field=field, alive=alive, fea_up=dict(fea_up),
        opt=optim.init_opt_state({"field": field, "fea_up": fea_up}, group_cfgs),
        stats=DensifyStats.zeros(field.capacity, dev),
        generator=torch.Generator(device=dev).manual_seed(seed),
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

    field_groups = set(optim.FIELD_GROUP_OF.values())
    opt = {name: (st._replace(mu=pad(st.mu), nu=pad(st.nu), accum=pad(st.accum))
                  if name in field_groups else st)
           for name, st in state.opt.items()}
    return dataclasses.replace(
        state, field=state.field.pad_to(new_capacity), alive=pad(state.alive), opt=opt,
        stats=DensifyStats(*(pad(x) for x in state.stats)))


def train_step(state: TrainState, camera: Camera, batch: Dict[str, torch.Tensor],
               cfg: GaussianSplatConfig,
               group_cfgs: Dict[str, optim.GroupConfig] = optim.DEFAULT_GROUPS,
               ) -> Tuple[TrainState, Dict[str, Any]]:
    """One optimization step. Returns (new state, metrics); the metrics
    are device tensors (no host sync)."""
    field = GaussianParams(*(x.detach().requires_grad_(True) for x in state.field))
    fea_up = {k: v.detach().requires_grad_(True) for k, v in state.fea_up.items()}
    probe = torch.zeros(state.field.capacity, 2, dtype=field.means.dtype,
                        device=field.means.device, requires_grad=True)
    model_state = {"field": field, "fea_up": fea_up}
    total, aux = train_loss(model_state, state.alive, camera, batch, state.step, cfg, probe=probe)

    leaves = list(field) + list(fea_up.values()) + [probe]
    grad_list = torch.autograd.grad(total, leaves, allow_unused=True)
    grad_list = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grad_list)]
    n_field = len(field)
    grads = {"field": GaussianParams(*grad_list[:n_field]),
             "fea_up": dict(zip(fea_up, grad_list[n_field:-1]))}
    probe_grad = grad_list[-1]

    stats = accumulate_stats(state.stats, probe_grad, aux["radii"].detach(),
                             camera.width, camera.height)
    new_model, new_opt = optim.apply_updates_grouped(
        {"field": state.field, "fea_up": state.fea_up}, grads, state.opt, state.step, group_cfgs)

    metrics = {
        "loss": total.detach(),
        "psnr": aux["psnr"].detach(),
        "gaussian_count": state.num_alive,
        "overflow": aux["overflow"],
        "dropped_tiles": aux["dropped_tiles"],
        "pair_overflow": aux["pair_overflow"],
        **{k: v.detach() for k, v in aux["loss_dict"].items()},
        **{f"grad_norm/{name}": optim.global_norm(g)
           for name, g in optim.to_groups(grads).items()},
    }
    new_state = dataclasses.replace(state, step=state.step + 1, field=new_model["field"],
                                    fea_up=new_model["fea_up"], opt=new_opt, stats=stats)
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
