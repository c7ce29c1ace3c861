"""The serving state and its conversion from the JAX package's parameters.

`state_from_numpy` takes the JAX state's leaves as numpy arrays (for
example `np.asarray` of each leaf of a restored JAX TrainState) and builds
the port's state, so a test can render one field through both packages."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from gaussiangrasper_torch.models.efd import FeaUp
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
