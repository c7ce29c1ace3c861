"""Gated LPIPS metric: the VGG16 feature distance (counterpart of the JAX
package's utils/perceptual.py).

The VGG16 weights cannot be fetched here, so the metric is gated: `lpips()`
returns None when no weight file is present, and the eval leaves the field
out. The weights load from a plain .npz (keys conv{i}_w (kh, kw, cin, cout)
and conv{i}_b, i = 0..12 in VGG16 order) at $GGT_VGG16_WEIGHTS or
~/.cache/ggt/vgg16.npz: the JAX package's file and layout. The stack runs
as `F.conv2d` / `F.max_pool2d` on the caller's device, in full float32
(`_device.full_f32`: cuDNN's default TF32 would round the convolutions to
about three digits).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gaussiangrasper_torch._device import full_f32, resolve_device

# VGG16 conv plan: output channels per conv layer, 'M' = 2x2 max pool.
# Feature taps after each pre-pool ReLU block: the layers LPIPS-vgg uses.
_PLAN = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
         512, 512, 512, "M", 512, 512, 512)
_TAP_AFTER_CONV = (1, 3, 6, 9, 12)  # conv indices whose ReLU output is tapped
_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)

_WEIGHTS: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None
_UNAVAILABLE = False
_ON_DEVICE: Dict[str, List[Tuple[torch.Tensor, torch.Tensor]]] = {}


def default_weight_path() -> Path:
    return Path(os.environ.get("GGT_VGG16_WEIGHTS", Path.home() / ".cache" / "ggt" / "vgg16.npz"))


def _load():
    global _WEIGHTS, _UNAVAILABLE
    if _WEIGHTS is not None or _UNAVAILABLE:
        return _WEIGHTS
    try:
        blob = np.load(default_weight_path())
        n_convs = sum(1 for p in _PLAN if p != "M")
        _WEIGHTS = [(np.asarray(blob[f"conv{i}_w"], np.float32),
                     np.asarray(blob[f"conv{i}_b"], np.float32)) for i in range(n_convs)]
    except Exception:
        _UNAVAILABLE = True
    return _WEIGHTS


def reset_cache() -> None:
    """Forget the loaded / missing state (for pointing at a fresh file)."""
    global _WEIGHTS, _UNAVAILABLE
    _WEIGHTS = None
    _UNAVAILABLE = False
    _ON_DEVICE.clear()


def lpips_available() -> bool:
    return _load() is not None


def random_weights(key=0) -> dict:
    """Random VGG16-shaped weights, He-normal from a numpy Generator seeded
    with `key` (the JAX package's, number for number)."""
    rng = np.random.default_rng(key)
    out = {}
    cin, i = 3, 0
    for p in _PLAN:
        if p == "M":
            continue
        fan = 3 * 3 * cin
        out[f"conv{i}_w"] = rng.normal(0.0, (2.0 / fan) ** 0.5, (3, 3, cin, p)).astype(np.float32)
        out[f"conv{i}_b"] = np.zeros(p, np.float32)
        cin, i = p, i + 1
    return out


def _device_weights(device: torch.device):
    """The loaded weights as (cout, cin, kh, kw) tensors on `device`."""
    key = str(device)
    if key not in _ON_DEVICE:
        _ON_DEVICE[key] = [
            (torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).to(device),
             torch.from_numpy(b).to(device)) for w, b in _WEIGHTS]
    return _ON_DEVICE[key]


def _features(x: torch.Tensor, weights) -> List[torch.Tensor]:
    """The VGG16 conv stack on (N, 3, H, W), returning the tap activations."""
    taps = []
    conv_i = 0
    for p in _PLAN:
        if p == "M":
            x = F.max_pool2d(x, 2, 2)
            continue
        w, b = weights[conv_i]
        x = torch.relu(F.conv2d(x, w, b, padding=1))
        if conv_i in _TAP_AFTER_CONV:
            taps.append(x)
        conv_i += 1
        if conv_i > max(_TAP_AFTER_CONV):
            break
    return taps


def lpips(pred, gt, device=None) -> Optional[float]:
    """Perceptual distance between two (H, W, 3) images in [0, 1] (numpy or
    tensors): unit-normalized VGG16 feature differences averaged over the
    tap layers (the uncalibrated LPIPS-vgg form). None when the weights are
    unavailable. Runs on `device` (None: cuda)."""
    if _load() is None:
        return None
    dev = resolve_device(device)
    weights = _device_weights(dev)

    def prep(img):
        x = torch.as_tensor(np.asarray(img.detach().cpu() if torch.is_tensor(img) else img,
                                       np.float32))
        x = (x - torch.from_numpy(_MEAN)) / torch.from_numpy(_STD)
        return x.permute(2, 0, 1)[None].contiguous().to(dev)

    total = 0.0
    with torch.no_grad(), full_f32():
        taps_a = _features(prep(pred), weights)
        taps_b = _features(prep(gt), weights)
        for fa, fb in zip(taps_a, taps_b):
            na = fa / torch.clamp(torch.linalg.norm(fa, dim=1, keepdim=True), min=1e-8)
            nb = fb / torch.clamp(torch.linalg.norm(fb, dim=1, keepdim=True), min=1e-8)
            total += float(torch.mean(torch.sum((na - nb) ** 2, dim=1)))
    return total / len(taps_a)
