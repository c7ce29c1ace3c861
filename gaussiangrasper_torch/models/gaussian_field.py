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


def knn_mean_distance(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean distance from each point to its k nearest other points
    (scipy's cKDTree; the JAX package uses scikit-learn's NearestNeighbors,
    which returns the same sorted distances)."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float64)
    distances, _ = cKDTree(pts).query(pts, k=k + 1)
    return distances[:, 1:].mean(axis=-1).astype(np.float32)


def seed_draws(rng: np.random.Generator, n: int, feature_dim: int = 32) -> Dict[str, np.ndarray]:
    """The uniform draws `init_from_seeds` consumes, from a numpy generator."""
    return {"quats": rng.random((3, n), np.float32),
            "features": rng.random((n, feature_dim), np.float32)}


def init_from_seeds(
    seed_xyz: np.ndarray,
    seed_rgb: np.ndarray,
    draws: Dict[str, np.ndarray],
    *,
    sh_degree: int = 4,
    capacity: Optional[int] = None,
    init_opacity: float = 0.1,
    device=None,
) -> Tuple[GaussianParams, torch.Tensor]:
    """Initialize from SfM / RGB-D seed points, seed_rgb in [0, 255]: scales
    from the mean distance to the 3 nearest seeds, base colour from the
    seed colour, uniform quats and features from injected uniforms (see
    `seed_draws`). Returns (params, alive)."""
    n = seed_xyz.shape[0]
    cap = capacity or n
    if cap < n:
        raise ValueError(f"capacity {cap} is below the {n} seed points")
    avg_dist = np.maximum(knn_mean_distance(seed_xyz), 1e-7)
    log_scales = torch.log(torch.as_tensor(avg_dist, device=device))[:, None].repeat(1, 3)
    shs = torch.zeros(n, sh.num_sh_bases(sh_degree), 3, device=device)
    shs[:, 0, :] = rgb_to_sh0(torch.as_tensor(np.asarray(seed_rgb, np.float32), device=device) / 255.0)
    feats = torch.tensor(np.asarray(draws["features"], np.float32), device=device)
    params = GaussianParams(
        means=torch.as_tensor(np.asarray(seed_xyz, np.float32), device=device),
        log_scales=log_scales,
        quats=random_quats(torch.tensor(np.asarray(draws["quats"], np.float32), device=device)),
        opacity_logits=torch.full((n,), math.log(init_opacity / (1.0 - init_opacity)), device=device),
        sh_coeffs=shs,
        features=feats * 2.0 - 1.0,
    )
    return params.pad_to(cap), torch.arange(cap, device=device) < n
