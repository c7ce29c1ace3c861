"""Host-side pixel samplers for the ray-marched (NeRF-family) trainers
(a copy of the JAX package's data/pixel_samplers.py).

Uniform, square-patch (patch_size x patch_size blocks, for patch-based
losses) and pair (pixel pairs within a radius, for pair/ranking losses)
samplers. They draw from a numpy Generator on the host and return
fixed-size (R, 2) int32 (row, col) arrays, the same numbers as the JAX
package's under the same Generator state."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PixelSampler:
    """Uniform sampler (ref pixel_samplers.py:53): R iid pixels."""

    rays_per_batch: int = 1024

    def sample(self, rng: np.random.Generator, height: int,
               width: int) -> np.ndarray:
        ys = rng.integers(0, height, self.rays_per_batch)
        xs = rng.integers(0, width, self.rays_per_batch)
        return np.stack([ys, xs], axis=-1).astype(np.int32)


@dataclasses.dataclass
class PatchPixelSampler(PixelSampler):
    """Square-patch sampler (ref :291-363): batch = (R // patch_size^2)
    patches of patch_size x patch_size contiguous pixels, row-major within
    each patch so consumers can reshape to (n, p, p, ...)."""

    patch_size: int = 8

    @property
    def effective_batch(self) -> int:
        p2 = self.patch_size ** 2
        return max(self.rays_per_batch // p2, 1) * p2

    def sample(self, rng, height, width):
        p = self.patch_size
        n = self.effective_batch // (p * p)
        y0 = rng.integers(0, max(height - p, 1), n)
        x0 = rng.integers(0, max(width - p, 1), n)
        dy, dx = np.mgrid[0:p, 0:p]
        ys = (y0[:, None, None] + dy[None]).reshape(-1)
        xs = (x0[:, None, None] + dx[None]).reshape(-1)
        return np.stack([ys, xs], axis=-1).astype(np.int32)


@dataclasses.dataclass
class PairPixelSampler(PixelSampler):
    """Pair sampler (ref :366-420): R//2 anchor pixels (kept at least
    `radius` from the border) each paired with a uniformly-offset pixel at
    most `radius` away; output interleaves [anchor0, mate0, anchor1, ...]
    exactly like the reference's (2m, 3) stack."""

    radius: int = 2

    @property
    def effective_batch(self) -> int:
        return max(self.rays_per_batch // 2, 1) * 2

    def sample(self, rng, height, width):
        r = self.radius
        m = self.effective_batch // 2
        ys = rng.integers(r, max(height - r, r + 1), m)
        xs = rng.integers(r, max(width - r, r + 1), m)
        dy = rng.integers(-r, r + 1, m)
        dx = rng.integers(-r, r + 1, m)
        anchors = np.stack([ys, xs], axis=-1)
        mates = np.stack([
            np.clip(ys + dy, 0, height - 1),
            np.clip(xs + dx, 0, width - 1),
        ], axis=-1)
        out = np.empty((2 * m, 2), np.int64)
        out[0::2] = anchors
        out[1::2] = mates
        return out.astype(np.int32)


def make_pixel_sampler(name: str, rays_per_batch: int, *,
                       patch_size: int = 8, pair_radius: int = 2):
    """Named factory mirroring the reference's sampler configs."""
    if name == "uniform":
        return PixelSampler(rays_per_batch)
    if name == "patch":
        return PatchPixelSampler(rays_per_batch, patch_size=patch_size)
    if name == "pair":
        return PairPixelSampler(rays_per_batch, radius=pair_radius)
    raise KeyError(f"unknown pixel sampler {name!r} "
                   "(have: uniform, patch, pair)")
