"""Device selection and float32 precision policy.

Entry points run on the card unless the caller asks for the CPU; a request
for cuda on a machine without one raises instead of quietly moving to the
CPU, so a measurement can never be taken on the wrong device.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means cuda. Raises if cuda is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cuda requested but torch.cuda.is_available() is False; "
            "pass --device cpu / device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """Run float32 matmuls and convolutions in full float32.

    cuDNN convolutions default to TF32 on Hopper (about three decimal
    digits), and the JAX package pins its SSIM blur and MLP to HIGHEST for
    the same reason: blur(x^2) - mu^2 cancels catastrophically at low
    precision. Sets both flags for the block and restores them after."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
