"""Plain reference of the `gaussiangrasper-efd` configuration: the
language-embedded splat model's render, loss, gradients, grouped Adam and
refine, as frozen copies of gaussiangrasper_torch at commit d90391f with
every kernel replaced by its plain PyTorch walk (each module names its
sources). It imports neither JAX nor anything of gaussiangrasper_torch.

`precision(tf32)` sets the float32 matmul precision the reference runs in:
full float32 (tf32=False), the configuration's own, or TF32, the nearest
precision below it, which is the benchmark's control."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matmuls and convolutions in TF32 (tf32=True) or in full
    float32 for the block; the previous flags are restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def config_from(model: dict):
    """The reference's GaussianSplatConfig from a configuration file's
    "model" (fea_up's hidden width is the benchmark's, not the config's)."""
    from .model import GaussianSplatConfig
    from .raster import RasterizeConfig

    return GaussianSplatConfig(**{k: v for k, v in model.items() if k not in ("fea_up_hidden", "raster")},
                               raster=RasterizeConfig(**model["raster"]))
