"""The ("dp", "gauss") mesh of sharded training (counterpart of the JAX
package's parallel/mesh.py).

  "dp"    data parallelism over cameras: each dp row renders another
          camera of the step's batch.
  "gauss" primitive sharding: each gauss rank holds capacity / gauss rows
          of the field, its optimizer moments and its densify stats.

Rank r sits at (r // gauss, r % gauss), the JAX mesh's row-major layout of
its devices. The dp group of a rank is its gauss column, the gauss group
its dp row.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist


def mesh_shape(dp: Optional[int], gauss: Optional[int], n: int) -> Tuple[int, int]:
    """The JAX rules: with neither given, dp 1 and gauss n; with one
    given, the other absorbs the rest; ValueError unless dp * gauss == n."""
    if dp is None and gauss is None:
        dp, gauss = 1, n
    elif dp is None:
        dp = n // gauss
    elif gauss is None:
        gauss = n // dp
    if dp * gauss != n:
        raise ValueError(f"dp({dp}) * gauss({gauss}) != device count ({n})")
    return dp, gauss


@dataclasses.dataclass
class Mesh:
    shape: Dict[str, int]    # {"dp": .., "gauss": ..}
    coords: Dict[str, int]   # this rank's place on each axis
    groups: Dict[str, dist.ProcessGroup]
    device: torch.device


def make_mesh(dp: Optional[int] = None, gauss: Optional[int] = None, device=None) -> Mesh:
    """The mesh over the initialized world (one rank a device). Every rank
    calls it, in the same order, since it creates process groups."""
    n = dist.get_world_size()
    dp, gauss = mesh_shape(dp, gauss, n)
    rank = dist.get_rank()
    row, col = divmod(rank, gauss)
    groups = {}
    for r in range(dp):
        g = dist.new_group([r * gauss + j for j in range(gauss)])
        if r == row:
            groups["gauss"] = g
    for j in range(gauss):
        g = dist.new_group([r * gauss + j for r in range(dp)])
        if j == col:
            groups["dp"] = g
    return Mesh(shape={"dp": dp, "gauss": gauss}, coords={"dp": row, "gauss": col},
                groups=groups, device=torch.device(device or "cpu"))
