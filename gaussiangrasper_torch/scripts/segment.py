"""Instance masks (+ boundary masks) for a capture (counterpart of the JAX
package's scripts/segment.py).

Two backends, as in the JAX tool:

  --backend classic  the default: bilateral filter, k-means++ colour
                     quantization and connected components, with the
                     OpenCV calls of the JAX tool replayed to the bit by
                     `utils/cv_segment.py` (the filter and the k-means
                     distance passes on the card, the order-dependent sums
                     and the components on the host), drawing from one
                     generator across the capture as cv2's thread RNG does.
  --backend sam      SAM's automatic masks over a point grid, run by the
                     port's own modules (`models/sam.py`,
                     `utils/sam_processor.py`) on --device from the cached
                     hub snapshot that transformers would load
                     (`utils/hub_snapshot.py`); exits naming the paths
                     searched where there is none. ViT-B
                     (`facebook/sam-vit-base`, the default) and ViT-H
                     (`facebook/sam-vit-huge`) run at their published widths.

Spans (`utils/profiler.PROFILER`, on only while a torch.profiler
records): `segment/preprocess` (the processor's resize, normalisation and
upload) and `segment/post` (the masks' upscaling, their copy out and the
ordering loop), beside the model's own; counter `sam/masks_kept`.

Writes <data>/masks/<stem>.npy (int32 instance ids, -1 = background) and
<data>/boundary_mask/<stem>.npy (uint8 validity).

    python -m gaussiangrasper_torch.scripts.segment --data SCENE [--backend classic|sam] \\
        [--sam-model facebook/sam-vit-base|facebook/sam-vit-huge] [--n-colors 8] \\
        [--min-area 200] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from gaussiangrasper_torch._device import full_f32, resolve_device
from gaussiangrasper_torch.models import sam
from gaussiangrasper_torch.utils import cv_segment, hub_snapshot
from gaussiangrasper_torch.utils.image_io import read_image
from gaussiangrasper_torch.utils.profiler import PROFILER
from gaussiangrasper_torch.utils.sam_processor import SamProcessor


def classic_instance_masks(img: np.ndarray, n_colors: int = 8, min_area: int = 200,
                           rng: Optional[cv_segment.OpenCVRNG] = None, device=None) -> np.ndarray:
    """Colour-quantized connected components as pseudo-instances: ids in
    cluster order, then component order, for components of at least
    `min_area` pixels. `rng` (None: `cv_segment.DEFAULT_RNG`) seeds the
    k-means; `device` (None: cuda) runs the filter and the distances."""
    dev = resolve_device(device)
    small = cv_segment.bilateral_filter(img, 9, 50, 50, device=dev)
    z = small.reshape(-1, 3).to(torch.float32)
    labels = cv_segment.kmeans_pp(z, n_colors, 10, 1.0, 3, rng=rng, device=dev)
    quant = labels.reshape(img.shape[:2])
    out = np.full(img.shape[:2], -1, np.int32)
    next_id = 0
    for c in range(n_colors):
        num, comp = cv_segment.connected_components(quant == c)
        keep = np.bincount(comp.ravel(), minlength=num) >= min_area
        keep[0] = False  # the background
        ids = np.full(num, -1, np.int32)
        ids[keep] = next_id + np.arange(int(keep.sum()), dtype=np.int32)
        out = np.where(ids[comp] >= 0, ids[comp], out)
        next_id += int(keep.sum())
    return out


def load_sam(model_name: str, device):
    """(SamModel on `device`, SamProcessor) of a cached snapshot; raises
    hub_snapshot.SnapshotNotFound."""
    model, snap = sam.load(model_name, device)
    return model, SamProcessor.from_snapshot(snap)


def sam_instance_masks(img: np.ndarray, model_name: str, min_area: int = 200,
                       model=None, proc=None, device=None) -> np.ndarray:
    """Automatic SAM masks over a point grid: one point every h // 8 rows
    and w // 8 columns, the masks in ascending order of each point's first
    IoU score (a later mask overwrites an earlier one), those of at least
    `min_area` pixels kept. model / proc: a loaded SamModel / SamProcessor
    (`load_sam`; None loads the cached snapshot of `model_name`); `device`
    (None: cuda) runs the model and the mask upscaling."""
    dev = resolve_device(device)
    if model is None or proc is None:
        model, proc = load_sam(model_name, dev)
    h, w = img.shape[:2]
    gy, gx = np.mgrid[0:h:max(h // 8, 1), 0:w:max(w // 8, 1)]
    points = [[int(x), int(y)] for y, x in zip(gy.ravel(), gx.ravel())]
    out = np.full((h, w), -1, np.int32)
    next_id = 0
    with torch.no_grad(), full_f32():
        with PROFILER.section("segment/preprocess"):
            inputs = proc(img, points, dev)
        pred_masks, iou_scores = model(inputs["pixel_values"], inputs["input_points"])
        scores = iou_scores.cpu().numpy()[0]  # the wait for the model
        with PROFILER.section("segment/post"):
            # the first of the three masks a point is the one kept: only it is upscaled
            masks = proc.post_process_masks(pred_masks[:, :, :1], inputs["original_sizes"],
                                            inputs["reshaped_input_sizes"])[0][:, 0].cpu().numpy()
            for i in np.argsort(scores[:, 0]):
                m = masks[i]
                if m.sum() >= min_area:
                    out[m] = next_id
                    next_id += 1
    PROFILER.count("sam/masks_kept", next_id)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Generate instance masks for a dataset")
    p.add_argument("--data", type=Path, required=True)
    p.add_argument("--backend", choices=("sam", "classic"), default="classic")
    p.add_argument("--sam-model", type=str, default="facebook/sam-vit-base")
    p.add_argument("--n-colors", type=int, default=8)
    p.add_argument("--min-area", type=int, default=200)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    if args.backend == "sam":
        try:
            model, proc = load_sam(args.sam_model, device)
        except hub_snapshot.SnapshotNotFound as e:
            raise SystemExit(
                f"SAM backend unavailable ({type(e).__name__}: {e}); "
                "use --backend classic or pre-cache the weights"
            )
    data = Path(args.data)
    (data / "masks").mkdir(exist_ok=True)
    (data / "boundary_mask").mkdir(exist_ok=True)
    images = sorted((data / "images").iterdir())
    for path in images:
        img = read_image(path)[..., :3]
        if args.backend == "sam":
            masks = sam_instance_masks(img, args.sam_model, args.min_area, model, proc, device)
        else:
            masks = classic_instance_masks(img, args.n_colors, args.min_area, device=device)
        np.save(data / "masks" / f"{path.stem}.npy", masks)
        np.save(
            data / "boundary_mask" / f"{path.stem}.npy",
            np.ones(img.shape[:2], np.uint8),
        )
        print(f"{path.name}: {masks.max() + 1} instances")


if __name__ == "__main__":
    main()
