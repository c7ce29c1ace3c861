"""Efficient Feature Distillation head: the `fea_up` MLP, 32 -> 128 ->
ReLU -> 512 (counterpart of the JAX package's models/efd.py).

The JAX package stores each layer as `w{i}` (d_in, d_out) and `b{i}`;
`nn.Linear.weight` is (d_out, d_in), so loading transposes."""

from __future__ import annotations

from typing import Dict, Sequence

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
        with full_f32():
            for i, layer in enumerate(self.layers):
                x = layer(x)
                if i < len(self.layers) - 1:
                    x = torch.relu(x)
        return x

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray]) -> "FeaUp":
        """Build from the JAX package's {w0, b0, w1, b1, ...} arrays."""
        n = len(arrays) // 2
        dims = [arrays["w0"].shape[0]] + [arrays[f"w{i}"].shape[1] for i in range(n)]
        mod = cls(dims[0], dims[-1], dims[1:-1])
        with torch.no_grad():
            for i, layer in enumerate(mod.layers):
                layer.weight.copy_(torch.tensor(np.asarray(arrays[f"w{i}"], np.float32).T))
                layer.bias.copy_(torch.tensor(np.asarray(arrays[f"b{i}"], np.float32)))
        return mod
