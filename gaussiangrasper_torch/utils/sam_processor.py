"""SAM's processor: an image and point prompts into the model's inputs, and
the low-resolution mask logits back to the image (counterpart of
transformers' `SamProcessor` / `SamImageProcessor`, which the JAX package's
scripts/segment.py calls).

Preprocessing, as the slow image processor does it:
- the longest edge resized to 1024 with Pillow's BILINEAR
  (`image_io.resize_bilinear`, Pillow's filter to the bit), the other edge
  to round(edge * scale);
- rescaled by 1/255 (in float64, then float32) and normalised by the
  ImageNet mean and std in float32;
- padded with zeros at the bottom and right to 1024 x 1024;
- each point scaled to the resized image, in float64.

Post-processing: the logits bilinearly up to the padded size, cropped to
the resized size, bilinearly to the original size (align_corners False),
then thresholded at 0. Settings come from the snapshot's
preprocessor_config.json over these defaults.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gaussiangrasper_torch.utils.image_io import resize_bilinear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class SamProcessor:
    longest_edge: int = 1024
    pad_size: Tuple[int, int] = (1024, 1024)  # height, width
    rescale_factor: float = 1 / 255
    image_mean: Tuple[float, ...] = IMAGENET_MEAN
    image_std: Tuple[float, ...] = IMAGENET_STD

    @classmethod
    def from_snapshot(cls, snap: Path) -> "SamProcessor":
        path = Path(snap) / "preprocessor_config.json"
        if not path.is_file():
            return cls()
        cfg = json.loads(path.read_text())
        kw = {}
        if "size" in cfg and "longest_edge" in cfg["size"]:
            kw["longest_edge"] = int(cfg["size"]["longest_edge"])
        if "pad_size" in cfg:
            kw["pad_size"] = (int(cfg["pad_size"]["height"]), int(cfg["pad_size"]["width"]))
        if "rescale_factor" in cfg:
            kw["rescale_factor"] = float(cfg["rescale_factor"])
        for key in ("image_mean", "image_std"):
            if key in cfg:
                kw[key] = tuple(float(v) for v in cfg[key])
        return cls(**kw)

    def resized_shape(self, h: int, w: int) -> Tuple[int, int]:
        scale = self.longest_edge * 1.0 / max(h, w)
        return int(h * scale + 0.5), int(w * scale + 0.5)

    def __call__(self, img: np.ndarray, points: Sequence[Sequence[float]], device) -> dict:
        """pixel_values (1, 3, pad h, pad w) float32, original_sizes and
        reshaped_input_sizes ((1, 2) int64, height and width) and
        input_points (1, P, 1, 2) float64 in pixels of the resized image,
        for P points (x, y) on the original image."""
        h, w = img.shape[:2]
        rh, rw = self.resized_shape(h, w)
        x = resize_bilinear(np.ascontiguousarray(img[..., :3]), rw, rh)
        x = (x.astype(np.float64) * self.rescale_factor).astype(np.float32)
        x = (x - np.array(self.image_mean, np.float32)) / np.array(self.image_std, np.float32)
        ph, pw = self.pad_size
        pixels = np.zeros((ph, pw, 3), np.float32)
        pixels[:rh, :rw] = x
        pts = np.array(points, np.float64).reshape(-1, 2)
        pts[:, 0] *= rw / w
        pts[:, 1] *= rh / h
        return {
            "pixel_values": torch.from_numpy(pixels.transpose(2, 0, 1).copy())[None].to(device),
            "original_sizes": torch.tensor([[h, w]]),
            "reshaped_input_sizes": torch.tensor([[rh, rw]]),
            "input_points": torch.from_numpy(pts)[None, :, None, :].to(device),
        }

    def upscale_logits(self, masks: torch.Tensor, original_size, reshaped_size) -> torch.Tensor:
        """(P, M, h, w) logits of one image up to its original size."""
        up = F.interpolate(masks, self.pad_size, mode="bilinear", align_corners=False)
        up = up[..., :int(reshaped_size[0]), :int(reshaped_size[1])]
        return F.interpolate(up, (int(original_size[0]), int(original_size[1])), mode="bilinear",
                             align_corners=False)

    def post_process_masks(self, masks: torch.Tensor, original_sizes, reshaped_input_sizes):
        """One boolean (P, M, H, W) tensor an image of (B, P, M, h, w) logits
        (logit > 0)."""
        return [self.upscale_logits(m, o.tolist(), r.tolist()) > 0
                for m, o, r in zip(masks, original_sizes, reshaped_input_sizes)]
