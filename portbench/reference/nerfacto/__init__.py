"""Plain reference of the `nerfacto` configuration: rays, the proposal
sampler, the hash-grid field, render_rays, the losses and one Adam step,
as frozen copies of gaussiangrasper_torch at commit d90391f (nerf.py names
its sources). It imports neither JAX nor anything of gaussiangrasper_torch.

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
    """The reference's NerfConfig from a configuration file's "model"
    (the keys the reference has; lists as tuples)."""
    import dataclasses

    from .nerf import NerfConfig

    names = {f.name for f in dataclasses.fields(NerfConfig)}
    return NerfConfig(**{k: (tuple(v) if isinstance(v, list) else v)
                         for k, v in model.items() if k in names})
