"""Efficient Feature Distillation head: the `fea_up` MLP, 32 -> 128 ->
ReLU -> 512 (counterpart of the JAX package's models/efd.py).

The JAX package stores each layer as `w{i}` (d_in, d_out) and `b{i}`;
`nn.Linear.weight` is (d_out, d_in), so loading transposes. Training keeps
the weights as a plain dict in `FeaUp.state_dict()` layout and runs them
through `mlp_apply`."""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from gaussiangrasper_torch._device import full_f32


class FeaUp(nn.Module):
    def __init__(self, in_dim: int = 32, out_dim: int = 512, hidden: Sequence[int] = (128,)):
        super().__init__()
        dims = [in_dim, *hidden, out_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_apply(dict(self.named_parameters()), x)

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray]) -> "FeaUp":
        """Build from the JAX package's {w0, b0, w1, b1, ...} arrays."""
        params = params_from_numpy(arrays)
        n = len(params) // 2
        dims = [params["layers.0.weight"].shape[1]] + [params[f"layers.{i}.weight"].shape[0]
                                                       for i in range(n)]
        mod = cls(dims[0], dims[-1], dims[1:-1])
        mod.load_state_dict(params)
        return mod


def mlp_apply(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """`FeaUp.forward` on a dict of its state (`layers.{i}.weight` (d_out,
    d_in) and `layers.{i}.bias`), so gradients reach plain tensors."""
    n = len(params) // 2
    with full_f32():
        for i in range(n):
            x = torch.nn.functional.linear(x, params[f"layers.{i}.weight"],
                                           params[f"layers.{i}.bias"])
            if i < n - 1:
                x = torch.relu(x)
    return x


def params_from_numpy(arrays: Mapping[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's {w{i} (d_in, d_out), b{i}} as `FeaUp.state_dict()`
    tensors (weights transposed)."""
    out = {}
    for i in range(len(arrays) // 2):
        w = np.asarray(arrays[f"w{i}"], np.float32).T.copy()
        out[f"layers.{i}.weight"] = torch.tensor(w, device=device)
        out[f"layers.{i}.bias"] = torch.tensor(np.asarray(arrays[f"b{i}"], np.float32),
                                               device=device)
    return out


class MLP(nn.Module):
    """Linear-ReLU-...-Linear with the JAX package's `init_mlp` layout: the
    parameters are `w{i}` (d_in, d_out) and `b{i}`, so a JAX MLP's arrays
    load by name, untransposed. Used by the ray-marched fields."""

    def __init__(self, in_dim: int, out_dim: int, hidden: Sequence[int] = (),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_dim, *hidden, out_dim]
        self.num_layers = len(dims) - 1
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            # torch.nn.Linear's default, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
            # for weights and bias alike
            bound = 1.0 / float(np.sqrt(d_in))
            w = (torch.rand((d_in, d_out), generator=generator) * 2.0 - 1.0) * bound
            b = (torch.rand((d_out,), generator=generator) * 2.0 - 1.0) * bound
            self.register_parameter(f"w{i}", nn.Parameter(w))
            self.register_parameter(f"b{i}", nn.Parameter(b))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = x @ getattr(self, f"w{i}") + getattr(self, f"b{i}")
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return x
