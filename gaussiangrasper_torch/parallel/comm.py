"""The process world and the collectives of sharded training, with their
transposes written out (the JAX package's XLA derives both from its
sharding annotations).

One process per rank: NCCL on the card (device `cuda:<local rank>`), gloo
on the CPU. `run_world` starts the ranks with `torch.multiprocessing`
(spawn) and a `FileStore` rendezvous in a fresh temporary directory, so no
port has to be free; under `torchrun` (WORLD_SIZE set) the ranks exist
already and `init_world` joins through the environment.

The autograd functions differ only in their backward, which follows from
who computes the loss:
  all_gather_rows   each gauss rank composites its own band from the
                    gathered rows, so each reaches them through other
                    pixels: the backward sums the bands' partial gradients
                    (reduce-scatter).
  all_gather_field  every gauss rank renders the full image from the
  all_gather_bands  gathered field (or the gathered bands) and computes the
                    same loss: each rank's gradient is already the whole
                    one, so the backward keeps the rank's own slice (a sum
                    would give gauss times the gradient).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def init_world(dp: int, gauss: int, device, *, rank: int = 0, store_dir: Optional[str] = None):
    """Join (or create) the dp x gauss world and return its `Mesh`.
    `store_dir`: the rendezvous directory `run_world` made (None under
    torchrun, which gives RANK / WORLD_SIZE / LOCAL_RANK in the
    environment). The backend follows the device: NCCL for cuda, gloo for
    the CPU."""
    from gaussiangrasper_torch.parallel.mesh import make_mesh

    device = torch.device(device)
    world_size = dp * gauss
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if store_dir is None:
            dist.init_process_group(backend, init_method="env://")
        else:
            store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
            dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    if dist.get_world_size() != world_size:
        raise ValueError(f"dp({dp}) * gauss({gauss}) != world size ({dist.get_world_size()})")
    return make_mesh(dp, gauss, device=device)


def close_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, fn: Callable, store_dir: str, args: tuple) -> None:
    fn(rank, store_dir, *args)


def run_world(world_size: int, fn: Callable, args: Sequence = (),
              timeout_s: Optional[float] = None) -> None:
    """Run `fn(rank, store_dir, *args)` in `world_size` spawned processes
    and wait for all of them; `fn` is a module-level function (it is
    pickled by name). A rank that raises raises here and the others are
    stopped; past `timeout_s` every rank is killed and TimeoutError
    raised."""
    import torch.multiprocessing as mp

    store_dir = tempfile.mkdtemp(prefix="ggt-world-")
    try:
        ctx = mp.start_processes(_rank_main, args=(fn, store_dir, tuple(args)), nprocs=world_size,
                                 join=False, start_method="spawn")
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=5.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks still running after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5.0)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, ...) -> (d * n, ...), rank order; no gradient."""
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    # all_gather_into_tensor's name from torch 2.13 on
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(out, x.contiguous(), group=group)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        d = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // d,) + tuple(g.shape[1:]))
        reduce_scatter = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)  # ditto
        reduce_scatter(out, g.contiguous(), op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


class _GatherKeepOwn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, g):
        d, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(d)[r].contiguous(), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The culled rows of every gauss shard, (d * v, A); backward: the
    reduce-scatter sum of the bands' gradients."""
    return _GatherRows.apply(x, group)


def all_gather_field(x: torch.Tensor, group) -> torch.Tensor:
    """A capacity-sharded leaf gathered whole for a replicated render;
    backward: the rank's own slice."""
    return _GatherKeepOwn.apply(x, group)


def all_gather_bands(x: torch.Tensor, group) -> torch.Tensor:
    """The bands' rows of the image stacked in band order; backward: the
    rank's own band."""
    return _GatherKeepOwn.apply(x, group)


def all_reduce_sum(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Sum each tensor over the group, in one collective on a flat buffer;
    no gradient."""
    if dist.get_world_size(group) == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i: i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out
