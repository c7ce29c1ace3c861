"""Sharded training on torch.distributed (counterpart of the JAX package's
parallel/): the world and its collectives (comm), the dp x gauss mesh,
the tile-sharded compositor, the sharded train step and its host loop."""

from gaussiangrasper_torch.parallel.mesh import make_mesh
from gaussiangrasper_torch.parallel.tile_shard import (
    composite_tile_sharded,
    tile_sharded_compositor,
)
from gaussiangrasper_torch.parallel.train import make_sharded_train_step, shard_train_state

__all__ = ["make_mesh", "make_sharded_train_step", "shard_train_state",
           "composite_tile_sharded", "tile_sharded_compositor"]
