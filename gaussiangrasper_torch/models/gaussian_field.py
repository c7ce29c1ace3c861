"""Gaussian field parameters: fixed capacity plus an alive mask
(counterpart of the JAX package's models/gaussian_field.py).

  means          (C, 3)     world positions
  log_scales     (C, 3)     log of per-axis scales
  quats          (C, 4)     (w, x, y, z), normalized at use
  opacity_logits (C,)       sigmoid -> opacity
  sh_coeffs      (C, 25, 3) SH colour coefficients (degree 4)
  features       (C, F)     latent CLIP features (F = 32)

Randomness is injected as numpy arrays (the JAX package draws it from a
key), so a test can feed both packages the same draws.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gaussiangrasper_torch.core import sh
from gaussiangrasper_torch.core.transforms import random_quats

SH_C0 = 0.28209479177387814
FIELD_KEYS = ("means", "log_scales", "quats", "opacity_logits", "sh_coeffs", "features")


def rgb_to_sh0(rgb):
    """RGB in [0, 1] -> 0th SH coefficient."""
    return (rgb - 0.5) / SH_C0


def sh0_to_rgb(c0):
    return c0 * SH_C0 + 0.5


class GaussianParams(NamedTuple):
    means: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    opacity_logits: torch.Tensor
    sh_coeffs: torch.Tensor
    features: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    def to(self, device) -> "GaussianParams":
        return GaussianParams(*(x.to(device) for x in self))

    def pad_to(self, new_capacity: int) -> "GaussianParams":
        """Grow capacity (new slots are dead); quats pad with identity."""
        extra = new_capacity - self.capacity
        if extra <= 0:
            return self

        def pad(x):
            return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])

        ident = self.quats.new_tensor([1.0, 0.0, 0.0, 0.0]).expand(extra, 4)
        return GaussianParams(
            means=pad(self.means), log_scales=pad(self.log_scales),
            quats=torch.cat([self.quats, ident]),
            opacity_logits=pad(self.opacity_logits),
            sh_coeffs=pad(self.sh_coeffs), features=pad(self.features),
        )


def field_from_numpy(arrays: Dict[str, np.ndarray], device=None) -> GaussianParams:
    return GaussianParams(*(torch.tensor(np.asarray(arrays[k], np.float32), device=device)
                            for k in FIELD_KEYS))


def random_draws(rng: np.random.Generator, n: int, feature_dim: int = 32) -> Dict[str, np.ndarray]:
    """The uniform draws `init_random` consumes, from a numpy generator."""
    f32 = np.float32
    return {
        "means": rng.random((n, 3), f32),
        "rgb": rng.random((n, 3), f32),
        "quats": rng.random((3, n), f32),
        "features": rng.random((n, feature_dim), f32),
    }


def init_random(
    draws: Dict[str, np.ndarray],
    *,
    extent: float = 10.0,
    sh_degree: int = 4,
    capacity: Optional[int] = None,
    init_opacity: float = 0.1,
    init_scale: Optional[float] = None,
    device=None,
) -> Tuple[GaussianParams, torch.Tensor]:
    """Random init: means uniform in a cube of side `extent`, random base
    colours, uniform quats and features, from injected uniforms (see
    `random_draws`). Returns (params, alive)."""
    d = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in draws.items()}
    cap = capacity or d["means"].shape[0]
    n = min(d["means"].shape[0], cap)
    if init_scale is None:
        init_scale = float(extent * (1.0 / max(n, 1)) ** (1.0 / 3.0))
    shs = torch.zeros(n, sh.num_sh_bases(sh_degree), 3, device=device)
    shs[:, 0, :] = rgb_to_sh0(d["rgb"][:n])
    params = GaussianParams(
        means=(d["means"][:n] - 0.5) * extent,
        log_scales=torch.full((n, 3), math.log(init_scale), device=device),
        quats=random_quats(d["quats"][:, :n]),
        opacity_logits=torch.full((n,), math.log(init_opacity / (1.0 - init_opacity)), device=device),
        sh_coeffs=shs,
        features=d["features"][:n] * 2.0 - 1.0,
    )
    params = params.pad_to(cap)
    alive = torch.arange(cap, device=device) < n
    return params, alive
