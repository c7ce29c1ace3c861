"""Plain reference of the `sam-vit-huge` configuration: SAM's forward
(ViT image encoder, prompt encoder, two-way mask decoder) and the automatic
instance-id map of scripts/segment.py, written in plain PyTorch from
Segment Anything (Kirillov et al., arXiv:2304.02643) and its code
(`segment_anything/modeling/`). It imports neither JAX nor anything of
gaussiangrasper_torch; `sam.py` names its departures from
`segment_anything`.

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
