"""Dynamic ray-batch sizing that targets a constant number of live samples
a batch (counterpart of the JAX package's engine/dynamic_batch.py).

Every step the ray count is rescaled by target / measured live samples,
then snapped to a power-of-two bucket between min_rays and max_rays: the
JAX package's control law and buckets, so both packages draw the same ray
counts from the same measurements."""

from __future__ import annotations

import math


class DynamicBatchSizer:
    """Tracks the ray count for the next batch.

    target_num_samples: total live samples to aim for a batch.
    max_num_samples_per_ray: dense samples a ray (sets the initial count).
    """

    def __init__(self, target_num_samples: int = 1 << 18, max_num_samples_per_ray: int = 1 << 10,
                 min_rays: int = 64, max_rays: int = 1 << 16):
        if min_rays & (min_rays - 1) or max_rays & (max_rays - 1):
            raise ValueError("min_rays/max_rays must be powers of two")
        self.target_num_samples = target_num_samples
        self.min_rays = min_rays
        self.max_rays = max_rays
        self._ideal = target_num_samples / max_num_samples_per_ray
        self.num_rays = self._bucket(self._ideal)

    def _bucket(self, ideal: float) -> int:
        """Nearest power of two (in log space), clipped to the range."""
        ideal = min(max(ideal, self.min_rays), self.max_rays)
        return 1 << round(math.log2(ideal))

    def update(self, num_samples_per_batch: int) -> int:
        """Feed the last batch's live-sample count; returns the ray count for
        the next one. The unbucketed ideal is kept, so repeated small
        corrections are not quantized away."""
        self._ideal = self._ideal * (self.target_num_samples / max(int(num_samples_per_batch), 1))
        self._ideal = min(max(self._ideal, self.min_rays), self.max_rays)
        self.num_rays = self._bucket(self._ideal)
        return self.num_rays
