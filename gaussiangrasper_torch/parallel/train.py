"""The sharded multi-camera train step (counterpart of the JAX package's
parallel/train.py).

Each rank holds capacity / gauss contiguous rows of the field, of the
field groups' Adam moments and accumulators and of the densify stats;
`fea_up`, its moments, the step and the split-noise generator are
replicated. A step renders the rank's own camera (its dp coordinate):
through the full-capacity gather (every gauss rank renders the whole
image from the gathered field) or through the tile-sharded compositor
(each gauss rank composites a band). The loss is divided by dp, so the
dp sum of the gradients is the gradient of the batch mean, as the JAX
step differentiates `jnp.mean(totals)`; the densify stats fold each dp
camera's probe gradient and radii in dp order, as its `fori_loop` does;
grouped Adam then runs on the local rows. The JAX step's collectives come
from its sharding annotations; here they are `parallel.comm`'s.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from gaussiangrasper_torch.core.cameras import Camera
from gaussiangrasper_torch.engine import optimizers as optim
from gaussiangrasper_torch.engine.refinement import DensifyStats, accumulate_stats
from gaussiangrasper_torch.engine.train_state import TrainState
from gaussiangrasper_torch.models.gaussian_field import GaussianParams
from gaussiangrasper_torch.models.model import GaussianSplatConfig, train_loss
from gaussiangrasper_torch.parallel import comm
from gaussiangrasper_torch.parallel.mesh import Mesh

_FIELD_GROUPS = frozenset(optim.FIELD_GROUP_OF.values())
_MAX_METRICS = ("overflow", "pair_overflow", "gathered_rows", "gather_overflow", "merge_overflow")


def _rows(mesh: Mesh, capacity: int) -> slice:
    d = mesh.shape["gauss"]
    if capacity % d != 0:
        raise ValueError(f"capacity {capacity} not divisible by gauss={d}")
    r, nl = mesh.coords["gauss"], capacity // d
    return slice(r * nl, (r + 1) * nl)


def shard_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """This rank's part of a whole TrainState, on the mesh's device: its
    rows of every capacity-length leaf, the rest replicated. The sharded
    state has no pose deltas, as the JAX package's has none."""
    if state.pose is not None:
        raise ValueError("sharded training runs without pose deltas (pose_opt_mode 'off')")
    rows = _rows(mesh, state.field.capacity)
    dev = mesh.device

    def local(x):
        return x[rows].to(dev)

    opt = {name: (st._replace(mu=local(st.mu), nu=local(st.nu), accum=local(st.accum),
                              count=st.count.to(dev))
                  if name in _FIELD_GROUPS else
                  optim.GroupOptState(*(optim.tree_map(lambda x: x.to(dev), part) for part in st)))
           for name, st in state.opt.items()}
    return dataclasses.replace(
        state, field=GaussianParams(*(local(x) for x in state.field)), alive=local(state.alive),
        fea_up={k: v.to(dev) for k, v in state.fea_up.items()}, opt=opt,
        stats=DensifyStats(*(local(x) for x in state.stats)))


def gather_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The whole TrainState from every gauss rank's part (every rank gets
    it)."""
    g = mesh.groups["gauss"]

    def whole(x):
        return comm.all_gather(x, g)

    opt = {name: (st._replace(mu=whole(st.mu), nu=whole(st.nu), accum=whole(st.accum))
                  if name in _FIELD_GROUPS else st) for name, st in state.opt.items()}
    return dataclasses.replace(
        state, field=GaussianParams(*(whole(x) for x in state.field)), alive=whole(state.alive),
        opt=opt, stats=DensifyStats(*(whole(x) for x in state.stats)))


def make_sharded_train_step(mesh: Mesh, cfg: GaussianSplatConfig, capacity: int,
                            tile_shard: bool = False, gather_budget: Optional[int] = None,
                            alive=None):
    """The step `(local state, this rank's camera, its batch) -> (local
    state, metrics)`; the metrics are the JAX step's, reduced over the
    mesh (means over dp, maxima of the overflow counts), on every rank.

    tile_shard: composite through `tile_shard.tile_sharded_compositor`,
    with `gather_budget` rows a rank (None: derived from `alive` when
    given, else the shard size)."""
    dp, gauss = mesh.shape["dp"], mesh.shape["gauss"]
    dg, gg = mesh.groups["dp"], mesh.groups["gauss"]
    compositor = None
    if tile_shard:
        from gaussiangrasper_torch.parallel.tile_shard import (
            derive_gather_budget,
            tile_sharded_compositor,
        )

        if gather_budget is None and alive is not None:
            gather_budget = derive_gather_budget(alive, gauss)
        compositor = tile_sharded_compositor(mesh, gather_budget=gather_budget)
    _rows(mesh, capacity)  # raises unless gauss divides the capacity

    def field_sum(x: torch.Tensor) -> torch.Tensor:
        return comm.all_gather_field(x[None], gg).sum(0)

    def step(state: TrainState, camera: Camera, batch: Dict[str, torch.Tensor]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        field = GaussianParams(*(x.detach().requires_grad_(True) for x in state.field))
        fea_up = {k: v.detach().requires_grad_(True) for k, v in state.fea_up.items()}
        probe = torch.zeros(field.means.shape[0], 2, dtype=field.means.dtype,
                            device=field.means.device, requires_grad=True)
        ms = {"field": field, "fea_up": fea_up}
        if compositor is not None:
            total, aux = train_loss(ms, state.alive, camera, batch, state.step, cfg, probe=probe,
                                    compositor=compositor, field_sum=field_sum)
            radii = aux["radii"]
        else:
            whole = {"field": GaussianParams(*(comm.all_gather_field(x, gg) for x in field)),
                     "fea_up": fea_up}
            total, aux = train_loss(whole, comm.all_gather(state.alive, gg), camera, batch,
                                    state.step, cfg, probe=comm.all_gather_field(probe, gg))
            radii = aux["radii"].chunk(gauss)[mesh.coords["gauss"]]
        leaves = list(field) + list(fea_up.values()) + [probe]
        grads = torch.autograd.grad(total / dp, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
        summed = comm.all_reduce_sum(grads[:-1], dg)
        n_field = len(field)
        grad_tree = {"field": GaussianParams(*summed[:n_field]),
                     "fea_up": dict(zip(fea_up, summed[n_field:]))}

        # densify stats: every dp camera's probe gradient and radii, in dp order
        probe_grads = comm.all_gather(grads[-1][None], dg)
        all_radii = comm.all_gather(radii.detach()[None], dg)
        first = comm.all_reduce_sum([state.stats.vis_counts.sum()], gg)[0] == 0.0
        stats = state.stats
        for i in range(dp):
            stats = accumulate_stats(stats, probe_grads[i], all_radii[i], camera.width,
                                     camera.height, first=first)
            first = torch.zeros_like(first)  # the first fold leaves every count at one
        new_model, new_opt = optim.apply_updates_grouped(
            {"field": state.field, "fea_up": state.fea_up}, grad_tree, state.opt, state.step)

        means = {"loss": total.detach() / dp, "psnr": aux["psnr"].detach() / dp,
                 **{k: v.detach() / dp for k, v in aux["loss_dict"].items()}}
        means = dict(zip(means, comm.all_reduce_sum(list(means.values()), dg)))
        maxima = {k: aux[k] for k in _MAX_METRICS if k in aux}
        if dp > 1:
            flat = torch.stack([v.to(torch.int64) for v in maxima.values()])
            torch.distributed.all_reduce(flat, op=torch.distributed.ReduceOp.MAX, group=dg)
            maxima = {k: flat[i].to(v.dtype) for i, (k, v) in enumerate(maxima.items())}
        count = comm.all_reduce_sum([state.alive.sum().to(torch.float32)], gg)[0]
        metrics = {**means, "gaussian_count": count.to(torch.int64), **maxima}
        new_state = dataclasses.replace(state, step=state.step + 1, field=new_model["field"],
                                        fea_up=new_model["fea_up"], opt=new_opt, stats=stats)
        return new_state, metrics

    return step
