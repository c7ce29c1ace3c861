"""The serving and training states built from the JAX package's leaves.

`state_from_numpy` and `train_state_from_numpy` take the JAX state's
leaves as numpy arrays (for example `np.asarray` of each leaf of a restored
JAX TrainState) and build the port's state, so a test can run one state
through both packages. The `fea_up` weights and the `up_net` moments and
accumulator are transposed into `FeaUp.state_dict()` layout."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from gaussiangrasper_torch.engine import optimizers as optim
from gaussiangrasper_torch.engine.refinement import DensifyStats
from gaussiangrasper_torch.engine.train_state import TrainState
from gaussiangrasper_torch.models.efd import FeaUp, params_from_numpy
from gaussiangrasper_torch.models.gaussian_field import GaussianParams, field_from_numpy


@dataclasses.dataclass
class ServeState:
    field: GaussianParams
    alive: torch.Tensor  # (capacity,) bool
    fea_up: FeaUp
    step: int

    def to(self, device) -> "ServeState":
        return ServeState(self.field.to(device), self.alive.to(device),
                          self.fea_up.to(device), self.step)


def state_from_numpy(field_arrays: Dict[str, np.ndarray], alive: np.ndarray,
                     fea_up_arrays: Dict[str, np.ndarray], step: int) -> ServeState:
    """field_arrays: means, log_scales, quats, opacity_logits, sh_coeffs,
    features; fea_up_arrays: the JAX MLP's w{i} (d_in, d_out) and b{i}."""
    return ServeState(
        field=field_from_numpy(field_arrays),
        alive=torch.tensor(np.asarray(alive, bool)),
        fea_up=FeaUp.from_numpy(fea_up_arrays),
        step=int(step),
    )


def train_state_from_numpy(field_arrays: Mapping[str, np.ndarray], alive: np.ndarray,
                           fea_up_arrays: Mapping[str, np.ndarray],
                           opt_arrays: Mapping[str, Mapping[str, Any]],
                           stats_arrays: Mapping[str, np.ndarray], step: int,
                           seed: int = 0, device=None) -> TrainState:
    """opt_arrays: group name -> {"mu", "nu", "count", "accum"} (the JAX
    GroupOptState's adam.mu / adam.nu / adam.count and accum; the up_net
    entries are {w{i}, b{i}} dicts); stats_arrays: grad_norm_sum,
    vis_counts, max_radii."""
    def leaf(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    def group(name, tree):
        return params_from_numpy(tree, device) if name == "up_net" else leaf(tree)

    dev = torch.device(device or "cpu")
    opt = {name: optim.GroupOptState(
        mu=group(name, g["mu"]), nu=group(name, g["nu"]),
        count=torch.tensor(int(np.asarray(g["count"])), dtype=torch.int32, device=device),
        accum=group(name, g["accum"])) for name, g in opt_arrays.items()}
    return TrainState(
        step=int(step),
        field=field_from_numpy(field_arrays, device),
        alive=torch.tensor(np.asarray(alive, bool), device=device),
        fea_up=params_from_numpy(fea_up_arrays, device),
        opt=opt,
        stats=DensifyStats(*(leaf(stats_arrays[k]) for k in DensifyStats._fields)),
        generator=torch.Generator(device=dev).manual_seed(seed),
    )
