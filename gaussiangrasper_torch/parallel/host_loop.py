"""Host loop of mesh-sharded training (counterpart of the JAX package's
parallel/host_loop.py).

`train_sharded` runs a Trainer's schedule on a dp x gauss world of ranks
(one process a rank). Each step every rank draws the whole dp batch from
its identically seeded datamanager, in order, and keeps its own camera
(its dp coordinate), so the draws are the JAX host loop's. Every
`refine_every` steps the whole state is gathered, refined by the
single-device `refine_step` on every rank alike (the same split-noise
generator) and cut back into the ranks' rows; the gather budget is then
derived again and the step rebuilt only when it moved. Rank 0 saves the
whole state in the trainer's checkpoint format, so the render and query
CLIs read a sharded run unchanged.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from gaussiangrasper_torch.engine import checkpoint as ckpt
from gaussiangrasper_torch.engine import train_state
from gaussiangrasper_torch.engine.trainer import _downscale_factor, downscale_batch, make_trainer
from gaussiangrasper_torch.parallel import comm
from gaussiangrasper_torch.parallel.mesh import mesh_shape
from gaussiangrasper_torch.parallel.tile_shard import derive_gather_budget
from gaussiangrasper_torch.parallel.train import (
    gather_train_state,
    make_sharded_train_step,
    shard_train_state,
)
from gaussiangrasper_torch.utils.writer import MetricsWriter

METRIC_KEYS = ("loss", "psnr", "gaussian_count", "overflow", "pair_overflow", "gathered_rows",
               "gather_overflow", "merge_overflow")


def train_sharded(trainer, dp: Optional[int] = None, gauss: Optional[int] = None,
                  tile_shard: Optional[bool] = None):
    """Run `trainer`'s schedule from `trainer.state` on a ("dp", "gauss")
    world; returns the whole final state (also set as `trainer.state`).

    The world: the one this process is already in (torchrun, or a rank of
    `comm.run_world`); else a world of one rank in this process when dp x
    gauss is 1; else dp x gauss spawned ranks, which take the state from a
    file and leave their result in the run's checkpoints, read back here.
    With one of dp / gauss given, the other takes the rest of the cards
    (the CPU: the rest of dp x gauss). tile_shard None: on when gauss > 1.
    """
    device = trainer.device
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        n = int(os.environ.get("WORLD_SIZE", 0)) or dist.get_world_size()
    elif device.type == "cuda" and (dp is None or gauss is None):
        n = torch.cuda.device_count()
    else:
        n = (dp or 1) * (gauss or 1)
    dp, gauss = mesh_shape(dp, gauss, n)
    cap = trainer.state.field.capacity
    if cap % gauss != 0:
        raise ValueError(f"capacity {cap} not divisible by gauss={gauss}")
    if tile_shard is None:
        tile_shard = gauss > 1

    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        mesh = comm.init_world(dp, gauss, device)
        return _run(trainer, mesh, tile_shard)
    if n == 1:
        store_dir = tempfile.mkdtemp(prefix="ggt-world-")
        try:
            mesh = comm.init_world(1, 1, device, store_dir=store_dir)
            return _run(trainer, mesh, tile_shard)
        finally:
            comm.close_world()
            shutil.rmtree(store_dir, ignore_errors=True)
    state_dir = Path(tempfile.mkdtemp(prefix="ggt-state-"))
    try:
        path = ckpt.save_checkpoint(state_dir, trainer.state)
        comm.run_world(n, _rank, (trainer.config, device.type, dp, gauss, tile_shard, str(path)))
    finally:
        shutil.rmtree(state_dir, ignore_errors=True)
    trainer.state = ckpt.load_checkpoint(ckpt.latest_checkpoint(trainer.config.ckpt_dir), device)
    return trainer.state


def _rank(rank: int, store_dir: str, config, device_type: str, dp: int, gauss: int,
          tile_shard: bool, state_path: str) -> None:
    """One spawned rank of `train_sharded`."""
    mesh = comm.init_world(dp, gauss, device_type, rank=rank, store_dir=store_dir)
    try:
        trainer = make_trainer(config, device=mesh.device)
        trainer.state = ckpt.load_checkpoint(Path(state_path), mesh.device)
        _run(trainer, mesh, tile_shard)
    finally:
        comm.close_world()


def _run(trainer, mesh, tile_shard: bool):
    cfg = trainer.config
    mcfg = cfg.model
    dp, gauss = mesh.shape["dp"], mesh.shape["gauss"]
    lead = dist.get_rank() == 0
    whole = trainer.state
    cap = whole.field.capacity
    state = shard_train_state(whole, mesh)

    def build_step(alive):
        if not tile_shard:
            return make_sharded_train_step(mesh, mcfg, cap), None
        budget = derive_gather_budget(alive, gauss)
        return make_sharded_train_step(mesh, mcfg, cap, tile_shard=True, gather_budget=budget), \
            budget

    step_fn, budget = build_step(whole.alive)
    del whole
    writer = None
    if lead:
        writer = trainer.writer or MetricsWriter(steps_per_log=cfg.steps_per_log,
                                                 max_steps=cfg.max_iterations)
    num_train = len(trainer.dm)
    start = state.step
    t0 = time.perf_counter()
    for step in range(start, cfg.max_iterations):
        d = _downscale_factor(mcfg, step)
        drawn = [trainer.dm.next_train_host() for _ in range(dp)]
        idx, host = drawn[mesh.coords["dp"]]
        cam, batch = downscale_batch(trainer.dm.to_device(host), trainer.dm.camera(idx), d)
        state, metrics = step_fn(state, cam, batch)

        if (step + 1) % mcfg.refine_every == 0:
            # the JAX loop refines at the first camera's size
            cam0 = trainer.dm.camera(drawn[0][0])
            cam0 = cam0.rescale(1.0 / d) if d > 1 else cam0
            whole = train_state.refine_step(gather_train_state(state, mesh), mcfg, cam0.width,
                                            cam0.height, num_train)
            state = shard_train_state(whole, mesh)
            if tile_shard and derive_gather_budget(whole.alive, gauss) != budget:
                step_fn, budget = build_step(whole.alive)
            del whole

        if writer is not None:
            writer.step(step, {k: metrics[k] for k in METRIC_KEYS if k in metrics},
                        pixels=dp * cam.width * cam.height)
        if (step + 1) % cfg.steps_per_save == 0 or step + 1 == cfg.max_iterations:
            whole = gather_train_state(state, mesh)
            if lead:
                print(f"saved {ckpt.save_checkpoint(cfg.ckpt_dir, whole)}")
            del whole
    dt = time.perf_counter() - t0
    steps = cfg.max_iterations - start
    if steps and lead:
        cam = trainer.dm.camera(0)
        px = steps * dp * cam.width * cam.height
        print(f"sharded: {steps} steps in {dt:.1f}s ({px / dt / 1e6:.2f} Mpx/s over mesh "
              f"{mesh.shape})")
    trainer.state = gather_train_state(state, mesh)
    return trainer.state
