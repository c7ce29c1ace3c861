"""Multi-scene training (counterpart of the JAX package's
engine/multi_scene.py).

S scenes advance together, one step each per iteration: the JAX package
vmaps its fused step over the stacked states; here `train_step` runs once
a scene (the kernels' autograd Functions do not batch under
torch.func.vmap). With `share_up_net` the `fea_up` parameters are
averaged across the scenes after every step, giving one CLIP-aligned
latent space for the whole collection; the Adam moments stay per scene.

With dp > 1 the scenes split over dp ranks, S / dp each (the JAX package
shards the stacked scene axis over a dp mesh), and the shared `fea_up`
mean and the metrics' means become all-reduces.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from gaussiangrasper_torch._device import resolve_device
from gaussiangrasper_torch.core.cameras import Camera
from gaussiangrasper_torch.engine import checkpoint as ckpt
from gaussiangrasper_torch.engine import train_state
from gaussiangrasper_torch.engine.train_state import TrainState
from gaussiangrasper_torch.engine.trainer import _downscale_factor, downscale_batch, make_trainer
from gaussiangrasper_torch.models.model import GaussianSplatConfig
from gaussiangrasper_torch.parallel import comm


def multi_scene_train_step(states: Sequence[TrainState], cameras: Sequence[Camera],
                           batches: Sequence[Dict[str, torch.Tensor]], cfg: GaussianSplatConfig,
                           share_up_net: bool = True, group=None, n_scenes: Optional[int] = None
                           ) -> Tuple[List[TrainState], Dict[str, torch.Tensor]]:
    """One step of every scene held here; returns the new states and the
    metrics' means over all `n_scenes` scenes (default: those given).
    `group`: the dp process group the scenes are split over (None: all
    scenes are here)."""
    n_scenes = n_scenes or len(states)
    out = [train_state.train_step(s, c, b, cfg) for s, c, b in zip(states, cameras, batches)]
    new_states = [s for s, _ in out]
    if share_up_net:
        sums = [torch.stack([s.fea_up[k] for s in new_states]).sum(0) for k in new_states[0].fea_up]
        if group is not None:
            sums = comm.all_reduce_sum(sums, group)
        mean = {k: v / n_scenes for k, v in zip(new_states[0].fea_up, sums)}
        new_states = [dataclasses.replace(s, fea_up=dict(mean)) for s in new_states]
    keys = list(out[0][1])
    sums = [torch.stack([m[k].float() for _, m in out]).sum(0) for k in keys]
    if group is not None:
        sums = comm.all_reduce_sum(sums, group)
    return new_states, {k: v / n_scenes for k, v in zip(keys, sums)}


def train_multi(config, data_dirs, share_up_net: bool = True, dp: Optional[int] = None,
                device=None) -> List[TrainState]:
    """Train the scenes of `data_dirs` together: one datamanager each, a
    common capacity (the most any scene asks for), per-scene checkpoints
    under <run>/scene_<i>/checkpoints. Returns the final states.

    dp > 1: the scenes split over dp ranks (S % dp == 0): under torchrun
    this process is one (it returns its own scenes' states); else the
    ranks are spawned here and the states read back from their
    checkpoints. None: every scene in this process."""
    n = len(data_dirs)
    if dp is None or dp == 1:
        return _run(config, data_dirs, share_up_net, device)
    if n % dp:
        raise ValueError(f"{n} scenes not divisible by dp={dp}")
    dev = resolve_device(device)
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        mesh = comm.init_world(dp, 1, dev)
        return _run(config, data_dirs, share_up_net, mesh.device, mesh.groups["dp"],
                    mesh.coords["dp"], dp)
    comm.run_world(dp, _rank, (config, list(data_dirs), share_up_net, dp, dev.type))
    return [ckpt.load_checkpoint(ckpt.latest_checkpoint(_scene_dir(config, i)), dev)
            for i in range(n)]


def _scene_dir(config, i: int):
    return config.run_dir / f"scene_{i}" / "checkpoints"


def _rank(rank: int, store_dir: str, config, data_dirs, share_up_net: bool, dp: int,
          device_type: str) -> None:
    mesh = comm.init_world(dp, 1, device_type, rank=rank, store_dir=store_dir)
    try:
        _run(config, data_dirs, share_up_net, mesh.device, mesh.groups["dp"], rank, dp)
    finally:
        comm.close_world()


def _run(config, data_dirs, share_up_net, device, group=None, rank: int = 0, dp: int = 1
         ) -> List[TrainState]:
    """The loop over this rank's scenes (`dp` ranks hold S / dp each)."""
    n = len(data_dirs)
    trainers = [make_trainer(dataclasses.replace(config, data=d), device=device)
                for d in data_dirs]
    caps = []
    for t in trainers:
        sp = t.dm.seed_points
        pts = len(sp[0]) if sp is not None else t.config.random_init_points
        caps.append(t.config.capacity or int(pts * t.config.capacity_multiplier))
    cap = max(caps)
    mine = range(rank * n // dp, (rank + 1) * n // dp)
    states = []
    for i in mine:
        trainers[i].config.capacity = cap
        states.append(trainers[i].setup())
    lead = rank == 0

    for step in range(states[0].step, config.max_iterations):
        d = _downscale_factor(config.model, step)
        cams, batches = [], []
        for i in mine:
            _, cam, batch = trainers[i].dm.next_train()
            cam, batch = downscale_batch(batch, cam, d)
            cams.append(cam)
            batches.append(batch)
        states, metrics = multi_scene_train_step(states, cams, batches, config.model,
                                                 share_up_net, group, n)
        if (step + 1) % config.model.refine_every == 0:
            # every scene refines at scene 0's camera size, as the JAX loop does
            size = torch.tensor([cams[0].width, cams[0].height] if lead else [0, 0],
                                device=states[0].field.means.device)
            if group is not None:
                dist.broadcast(size, src=0, group=group)
            w, h = size.tolist()
            states = [train_state.refine_step(st, config.model, w, h, len(trainers[i].dm))
                      for st, i in zip(states, mine)]
        if step % config.steps_per_log == 0 and lead:
            print(f"[{step:6d}] scenes={n} loss={float(metrics['loss']):.4f} "
                  f"psnr={float(metrics['psnr']):.2f}", flush=True)
        if (step + 1) % config.steps_per_save == 0 or step + 1 == config.max_iterations:
            for st, i in zip(states, mine):
                ckpt.save_checkpoint(_scene_dir(config, i), st)
            if lead:
                print(f"saved {n} scene checkpoints at step {step + 1}")
    return states
