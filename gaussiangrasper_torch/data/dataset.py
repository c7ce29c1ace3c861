"""Multi-channel supervision dataset (GaussianGrasper directory convention;
a copy of the JAX package's data/dataset.py reading images with the port's
stdlib PNG reader).

Alongside each image `<root>/images/<name>.png` the scan pipeline writes,
keyed by the same stem,

  normals/<stem>.npy        (H, W, 3) camera-capture-frame normals
  depths/<stem>.npy         (H, W) metric depth
  features/<stem>.npy       per-pixel CLIP features (possibly downscaled)
  masks/<stem>.npy          (H, W) int SAM instance ids (-1 = none)
  boundary_mask/<stem>.npy  (H, W) 0/1 validity mask

with a `before/` subdirectory fallback for scene-update datasets. Depth is
scaled by the dataparser scale; normals are rotated into the oriented world
frame by the dataparser transform. All host-side numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from gaussiangrasper_torch.data.dataparsers.base import DataparserOutputs
from gaussiangrasper_torch.utils.image_io import read_image


def _sibling(image_path: Path, kind: str) -> Optional[Path]:
    """Map .../images/<stem>.<ext> (or .../images/before/<stem>) to the
    sibling channel directory."""
    parts = list(image_path.parts)
    try:
        i = len(parts) - 1 - parts[::-1].index("images")
    except ValueError:
        return None
    stem = Path(parts[-1]).stem
    sub = parts[i + 1 : -1]  # e.g. ["before"]
    cand = Path(*parts[:i], kind, *sub, stem + ".npy")
    if cand.exists():
        return cand
    # before/-fallback: channels may live only under the un-suffixed dir
    if sub:
        cand = Path(*parts[:i], kind, stem + ".npy")
        if cand.exists():
            return cand
    return None


@dataclass
class InputDataset:
    outputs: DataparserOutputs

    def __len__(self) -> int:
        return len(self.outputs.image_filenames)

    def load_image(self, idx: int) -> np.ndarray:
        """(H, W, 3) float32 in [0, 1] from a PNG or JPEG frame; grey is
        repeated, alpha composited over white. As the reference's Pillow
        array does: a 16-bit grey PNG keeps its 0-65535 range over 255, a
        palette PNG loads as its indices over 255, a 1-bit grey one as 0 or
        1/255, and a CMYK JPEG's fourth channel composites as alpha."""
        img = read_image(self.outputs.image_filenames[idx])
        if img.ndim == 2:
            img = img[..., None].repeat(3, -1)
        if img.shape[-1] == 2:  # grey + alpha
            img = np.concatenate([img[..., :1].repeat(3, -1), img[..., 1:]], -1)
        if img.shape[-1] == 4:
            a = img[..., 3:4] / 255.0
            img = img[..., :3] * a + 255.0 * (1 - a)
        return (img[..., :3] / 255.0).astype(np.float32)

    def get_data(self, idx: int) -> Dict[str, np.ndarray]:
        image = self.load_image(idx)
        h, w = image.shape[:2]
        path = self.outputs.image_filenames[idx]
        out: Dict[str, np.ndarray] = {"image": image}

        p = _sibling(path, "depths")
        if p is not None:
            depth = np.load(p).astype(np.float32)
            out["depth"] = depth * self.outputs.dataparser_scale
        else:
            out["depth"] = np.zeros((h, w), np.float32)

        p = _sibling(path, "normals")
        if p is not None:
            normal = np.load(p).astype(np.float32)
            # rotate capture-frame normals into the oriented world frame
            rot = self.outputs.dataparser_transform[:3, :3]
            out["normal"] = normal.reshape(-1, 3) @ rot.T
            out["normal"] = out["normal"].reshape(normal.shape)
        else:
            out["normal"] = np.zeros((h, w, 3), np.float32)

        p = _sibling(path, "boundary_mask")
        out["valid_mask"] = (
            np.load(p).astype(bool) if p is not None else np.ones((h, w), bool)
        )

        p = _sibling(path, "masks")
        out["sam_mask"] = (
            np.load(p).astype(np.int32)
            if p is not None
            else np.full((h, w), -1, np.int32)
        )

        p = _sibling(path, "features")
        if p is not None:
            out["clip_features"] = np.load(p).astype(np.float32)
        return out

    def has_channel(self, idx: int, kind: str) -> bool:
        return _sibling(self.outputs.image_filenames[idx], kind) is not None
