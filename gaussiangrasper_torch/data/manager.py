"""Full-image datamanager: a host cache of every view plus per-step batches
(counterpart of the JAX package's data/manager.py).

Cameras are drawn at random without replacement per epoch; the SAM-mask
pixel pairs and the CLIP distillation pixels are drawn as fixed-size index
arrays, uniform over pixels within each mask id and uniform over present
ids, by the native C++ sampler or, on a host without g++, by the numpy
branch. Both branches, the camera order and the seeds drawn for the native
sampler are those of the JAX package, so the same seed gives the same
batches.

Batches are torch tensors on the training device. The cached views and each
step's draws sit in pinned host memory (when the device is a card) and go
to the device with non-blocking copies; `host_batch` and `to_device` split
the two halves so a prefetch thread can prepare host batches while the main
thread issues the copies (`data/prefetch.py`).

A view with lens distortion is undistorted once, when it is cached, on the
manager's device (`undistort_image`, OpenCV's functions in torch:
`data/undistort.py`); its camera takes the new intrinsics and zero
distortion. Only the image is resampled: depth, normal, valid_mask and
sam_mask stay in the original camera's frame, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gaussiangrasper_torch import native
from gaussiangrasper_torch._device import resolve_device
from gaussiangrasper_torch.core.cameras import Camera
from gaussiangrasper_torch.data.dataparsers.base import DataparserOutputs, ParsedCamera
from gaussiangrasper_torch.data.dataset import InputDataset
from gaussiangrasper_torch.data.undistort import undistort

VIEW_KEYS = ("image", "depth", "normal", "valid_mask", "sam_mask")
"""Per-view arrays cached in host memory and copied every step."""


@dataclasses.dataclass
class SamplerConfig:
    max_groups: int = 32        # SAM mask ids per step
    pairs_per_group: int = 800  # contrastive pairs per id
    num_points: int = 1000      # CLIP distillation pixels
    clip_dim: int = 512


def undistort_image(img: np.ndarray, cam: ParsedCamera,
                    device=None) -> Tuple[np.ndarray, ParsedCamera]:
    """A uint8 view undistorted on `device` (default cpu) and its camera
    with the new intrinsics and zero distortion; views without distortion
    come back as they are. The JAX package's undistort_image, OpenCV's
    perspective (getOptimalNewCameraMatrix alpha 0 + undistort) and fisheye
    (estimateNewCameraMatrixForUndistortRectify balance 0 +
    initUndistortRectifyMap + remap) branches."""
    if not np.any(cam.distortion):
        return img, cam
    k = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float64)
    src = torch.from_numpy(np.ascontiguousarray(img)).to(torch.device(device or "cpu"))
    out, newk = undistort(src, k, cam.distortion, fisheye=cam.camera_type == "fisheye")
    cam2 = dataclasses.replace(
        cam, fx=float(newk[0, 0]), fy=float(newk[1, 1]), cx=float(newk[0, 2]),
        cy=float(newk[1, 2]), distortion=np.zeros(6))
    return out.cpu().numpy(), cam2


class FullImageDatamanager:
    """Caches all per-view data host-side; emits (Camera, batch) pairs whose
    batch leaves are fixed-shape tensors on `device` (None means cuda)."""

    def __init__(
        self,
        outputs: DataparserOutputs,
        sampler: SamplerConfig = SamplerConfig(),
        seed: int = 0,
        cache_all: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        device=None,
    ):
        """process_index/count: each process trains on its round-robin
        camera subset, with seed + process_index."""
        self.outputs = outputs
        self.dataset = InputDataset(outputs)
        self.sampler = sampler
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        self.rng = np.random.default_rng(seed + process_index)
        self.sampler_branch: Optional[str] = None  # "native" or "numpy", set by the first batch
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._host: Dict[int, Dict[str, torch.Tensor]] = {}
        self._cams: Dict[int, Camera] = {}
        self._order: List[int] = []
        self.cameras: List[ParsedCamera] = list(outputs.cameras)
        n = len(self.dataset)
        self._local_indices = [
            i for i in range(n) if i % process_count == process_index
        ] or list(range(n))
        if cache_all:
            for i in self._local_indices:
                self._load(i)

    def __len__(self) -> int:
        return len(self.dataset)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self._pin else t

    def _load(self, idx: int) -> Dict[str, np.ndarray]:
        if idx not in self._cache:
            data = self.dataset.get_data(idx)
            cam = self.cameras[idx]
            if np.any(cam.distortion):
                # the uint8 round trip truncates, as the JAX package's does
                img, self.cameras[idx] = undistort_image(
                    (data["image"] * 255).astype(np.uint8), cam, self.device)
                data["image"] = img.astype(np.float32) / 255.0
                self._cams.pop(idx, None)
            # ids outside the validity mask never get sampled
            data["sam_mask"] = np.where(data["valid_mask"], data["sam_mask"], -1).astype(np.int32)
            self._cache[idx] = data
            self._host[idx] = {k: self._tensor(data[k]) for k in VIEW_KEYS}
        return self._cache[idx]

    def view_data(self, idx: int) -> Dict[str, np.ndarray]:
        """The cached host arrays of view idx (image, depth, normal,
        valid_mask, valid-gated sam_mask, clip_features when present)."""
        return self._load(idx)

    def camera(self, idx: int) -> Camera:
        if idx not in self._cams:
            c = self.cameras[idx]
            self._cams[idx] = Camera.create(c.fx, c.fy, c.cx, c.cy, c.camera_to_world,
                                            c.width, c.height, device=self.device)
        return self._cams[idx]

    # ---- sampling: the JAX package's draws, fixed-size ----

    def _sample_mask_pairs(self, sam: np.ndarray):
        s = self.sampler
        g, p = s.max_groups, s.pairs_per_group
        ids = np.unique(sam)
        ids = ids[ids > -1]
        if len(ids) > g:
            ids = self.rng.choice(ids, g, replace=False)
        pair_a = np.zeros((g, p, 2), np.int32)
        pair_b = np.zeros((g, p, 2), np.int32)
        pair_valid = np.zeros((g, p), bool)
        group_valid = np.zeros((g,), bool)
        for gi, mid in enumerate(ids):
            ys, xs = np.nonzero(sam == mid)
            if len(ys) < 2:
                continue
            ia = self.rng.integers(0, len(ys), p)
            ib = self.rng.integers(0, len(ys), p)
            pair_a[gi, :, 0], pair_a[gi, :, 1] = ys[ia], xs[ia]
            pair_b[gi, :, 0], pair_b[gi, :, 1] = ys[ib], xs[ib]
            pair_valid[gi] = True
            group_valid[gi] = True
        return pair_a, pair_b, pair_valid, group_valid

    def _sample_points(self, sam: np.ndarray, clip: Optional[np.ndarray], h, w):
        """Distillation pixels: uniform within the union of masks, the
        samples split evenly per id."""
        s = self.sampler
        n = s.num_points
        points = np.zeros((n, 2), np.int32)
        valid = np.zeros((n,), bool)
        gt = np.zeros((n, s.clip_dim), np.float32)
        ids = np.unique(sam)
        ids = ids[ids > -1]
        if len(ids) == 0 or clip is None:
            return points, valid, gt
        per = max(n // len(ids), 1)
        k = 0
        for mid in ids:
            if k >= n:
                break
            ys, xs = np.nonzero(sam == mid)
            if len(ys) == 0:
                continue
            take = min(per, n - k)
            sel = self.rng.integers(0, len(ys), take)
            points[k : k + take, 0] = ys[sel]
            points[k : k + take, 1] = xs[sel]
            valid[k : k + take] = True
            k += take
        fh, fw = clip.shape[:2]
        fy = (points[:, 0] * fh) // max(h, 1)
        fx = (points[:, 1] * fw) // max(w, 1)
        gt[valid] = clip[fy[valid], fx[valid]]
        return points, valid, gt

    def _draw(self, data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        h, w = data["image"].shape[:2]
        sam = data["sam_mask"]
        s = self.sampler
        clip = data.get("clip_features")
        fast = native.sample_mask_batch(
            sam, s.max_groups, s.pairs_per_group, s.num_points,
            seed=int(self.rng.integers(1, 2**63)),
        )
        self.sampler_branch = "numpy" if fast is None else "native"
        if fast is not None:
            pair_a, pair_b, pair_valid, group_valid, points, point_valid = fast
            gt_clip = np.zeros((s.num_points, s.clip_dim), np.float32)
            if clip is not None and point_valid.any():
                fh, fw = clip.shape[:2]
                fy = (points[:, 0] * fh) // max(h, 1)
                fx = (points[:, 1] * fw) // max(w, 1)
                gt_clip[point_valid] = clip[fy[point_valid], fx[point_valid]]
            else:
                point_valid = np.zeros_like(point_valid)
        else:
            pair_a, pair_b, pair_valid, group_valid = self._sample_mask_pairs(sam)
            points, point_valid, gt_clip = self._sample_points(sam, clip, h, w)
        return {"pair_a": pair_a, "pair_b": pair_b, "pair_valid": pair_valid,
                "group_valid": group_valid, "points": points, "point_valid": point_valid,
                "gt_clip": gt_clip}

    def host_batch(self, idx: int) -> Dict[str, torch.Tensor]:
        """View idx's batch in (pinned) host memory: the cached view
        tensors and this step's draws."""
        data = self._load(idx)
        draws = {k: self._tensor(v) for k, v in self._draw(data).items()}
        return {**self._host[idx], **draws}

    def to_device(self, host: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.device, non_blocking=True) for k, v in host.items()}

    def get_batch(self, idx: int) -> Tuple[Camera, Dict[str, torch.Tensor]]:
        return self.camera(idx), self.to_device(self.host_batch(idx))

    def next_train_host(self) -> Tuple[int, Dict[str, torch.Tensor]]:
        """Random camera without replacement per epoch, restricted to this
        process's shard, and its host batch."""
        if not self._order:
            self._order = [
                self._local_indices[j]
                for j in self.rng.permutation(len(self._local_indices))
            ]
        idx = int(self._order.pop())
        return idx, self.host_batch(idx)

    def next_train(self) -> Tuple[int, Camera, Dict[str, torch.Tensor]]:
        idx, host = self.next_train_host()
        return idx, self.camera(idx), self.to_device(host)

    @property
    def seed_points(self):
        return self.outputs.seed_points
