"""The three OpenCV calls of the classic segmentation backend, replayed to
the bit without OpenCV (the card machine has none):

- `bilateral_filter`: `cv2.bilateralFilter` on a uint8 (H, W, 3) image, as
  torch ops on the caller's device;
- `OpenCVRNG` and `kmeans_pp`: `cv::RNG` and `cv::kmeans` with
  KMEANS_PP_CENTERS, the distance passes on the device, the sums whose
  order decides the result on the host;
- `connected_components`: `cv2.connectedComponents` (8-connectivity) with
  OpenCV's label numbering.

Every product and sum below is its own op: no fused multiply-add, so the
card and the CPU round alike.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from gaussiangrasper_torch._device import resolve_device

ImageLike = Union[np.ndarray, torch.Tensor]


# --- bilateral filter --------------------------------------------------------------------


def _bilateral_tables(d: int, sigma_color: float, sigma_space: float, cn: int):
    """OpenCV's radius, the offsets within it in row-major order with their
    float32 space weights, and the float32 colour weights indexed by the
    summed absolute difference. The tables are built in float64 with the
    C library's exp, as OpenCV builds them, then rounded to float32."""
    if d <= 0 or sigma_color <= 0 or sigma_space <= 0:
        raise ValueError(f"bilateral_filter takes d, sigma_color, sigma_space > 0, got "
                         f"{d}, {sigma_color}, {sigma_space}")
    color_coeff = -0.5 / (sigma_color * sigma_color)
    space_coeff = -0.5 / (sigma_space * sigma_space)
    radius = max(d // 2, 1)
    color_weight = np.array([math.exp(i * i * color_coeff) for i in range(256 * cn)], np.float32)
    offsets, space_weight = [], []
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            r = math.sqrt(float(i) * i + float(j) * j)
            if r > radius:
                continue
            offsets.append((i, j))
            space_weight.append(math.exp(r * r * space_coeff))
    return radius, offsets, np.array(space_weight, np.float32), color_weight


def bilateral_filter(img: ImageLike, d: int = 9, sigma_color: float = 50.0,
                     sigma_space: float = 50.0, device=None) -> torch.Tensor:
    """`cv2.bilateralFilter(img, d, sigma_color, sigma_space)` for a uint8
    (H, W, 3) image, on `device` (None: cuda); returns uint8 (H, W, 3).

    BORDER_REFLECT_101 padding by the radius; for each offset in turn,
    w = space_weight * color_weight[|db| + |dg| + |dr|], wsum += w and
    sum_c += c * w in float32; out = round_half_even(sum_c * (1 / wsum))."""
    dev = resolve_device(device)
    src = torch.as_tensor(img).to(dev)
    if src.dtype != torch.uint8 or src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"bilateral_filter takes uint8 (H, W, 3), got {tuple(src.shape)} "
                         f"{src.dtype}")
    h, w, cn = src.shape
    radius, offsets, sw, cw = _bilateral_tables(d, sigma_color, sigma_space, cn)
    sw = torch.as_tensor(sw, device=dev)
    cw = torch.as_tensor(cw, device=dev)
    x = src.to(torch.float32)
    pad = F.pad(x.permute(2, 0, 1)[None], (radius,) * 4, mode="reflect")[0].permute(1, 2, 0)
    wsum = torch.zeros((h, w), dtype=torch.float32, device=dev)
    acc = torch.zeros((h, w, cn), dtype=torch.float32, device=dev)
    for k, (i, j) in enumerate(offsets):
        nb = pad[radius + i: radius + i + h, radius + j: radius + j + w]
        idx = (nb - x).abs().sum(dim=2).to(torch.int64)  # exact: small integers
        wk = sw[k] * cw[idx]
        wsum = wsum + wk
        acc = acc + nb * wk[..., None]
    out = torch.round(acc * (1.0 / wsum)[..., None])
    return out.to(torch.uint8)


# --- cv::RNG and cv::kmeans ---------------------------------------------------------------


class OpenCVRNG:
    """`cv::RNG`: a multiply-with-carry generator on a 64-bit state.

    A zero seed means 0xffffffff, as in OpenCV, and 0xffffffff is also the
    state of a fresh thread's `cv::theRNG()`, so `OpenCVRNG(s)` replays
    the draws that follow `cv2.setRNGSeed(s)`."""

    COEFF = 4164903690
    MASK64 = (1 << 64) - 1

    def __init__(self, state: int = 0xFFFFFFFF):
        self.state = int(state) & self.MASK64 or 0xFFFFFFFF

    def next(self) -> int:
        """`RNG::next`: the new state's low 32 bits."""
        s = self.state
        self.state = ((s & 0xFFFFFFFF) * self.COEFF + (s >> 32)) & self.MASK64
        return self.state & 0xFFFFFFFF

    def uniform_double(self) -> float:
        """`(double)rng`: two draws, the first the high word, in [0, 1)."""
        hi = self.next()
        return float((hi << 32) | self.next()) * 5.4210108624275221700372640043497e-20


# the generator the classic backend draws from unless given one: the
# counterpart of cv2's per-thread `theRNG()`, one stream across calls
DEFAULT_RNG = OpenCVRNG()


def _sqdist(zt: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """OpenCV's float32 `normL2Sqr` of every sample against c: zt is the
    samples transposed, (dims, N); c is (dims,) or (dims, N).
    ((t0 * t0) + t1 * t1) + t2 * t2, each op on its own."""
    t = zt - (c[:, None] if c.ndim == 1 else c)
    d = t[0] * t[0]
    for j in range(1, zt.shape[0]):
        d = d + t[j] * t[j]
    return d


def _seq_sum(x: np.ndarray) -> float:
    """A float64 sum in sample order, as OpenCV's `s += x[i]` loops run."""
    return float(np.cumsum(x, dtype=np.float64)[-1])


def _cv_sum(x: np.ndarray) -> float:
    """`cv::sum` of a float64 vector: four samples added together, then to
    the running sum, the last len % 4 one by one."""
    x = np.asarray(x, np.float64)
    n4 = len(x) // 4 * 4
    g = x[:n4].reshape(-1, 4)
    groups = ((g[:, 0] + g[:, 1]) + g[:, 2]) + g[:, 3]
    return _seq_sum(np.concatenate([groups, x[n4:]]))


def _pp_pick(dist: np.ndarray, p: float) -> int:
    """The first ci with p - dist[0] - ... - dist[ci] <= 0 (float64, in
    order), capped at N - 1: `generateCentersPP`'s walk."""
    n = len(dist)
    walk = np.cumsum(np.concatenate([[p], -dist[: n - 1].astype(np.float64)]))[1:]
    hit = np.flatnonzero(walk <= 0)
    return int(hit[0]) if len(hit) else n - 1


def _centers_pp(zt: torch.Tensor, k: int, rng: OpenCVRNG, trials: int = 3) -> torch.Tensor:
    """OpenCV's `generateCentersPP`: k-means++ seeding with `trials`
    candidates a centre, the one whose min-distance sum is least kept;
    (k, dims)."""
    n = zt.shape[1]
    idx = [rng.next() % n]
    dist = _sqdist(zt, zt[:, idx[0]])
    dist_h = dist.cpu().numpy()
    sum0 = _seq_sum(dist_h)
    for _ in range(1, k):
        best_sum, best = math.inf, None
        for _ in range(trials):
            ci = _pp_pick(dist_h, rng.uniform_double() * sum0)
            tdist = torch.minimum(_sqdist(zt, zt[:, ci]), dist)
            tdist_h = tdist.cpu().numpy()
            s = _seq_sum(tdist_h)
            if s < best_sum:
                best_sum, best = s, (ci, tdist, tdist_h)
        if best is None:
            raise ValueError("kmeans: can't update cluster center (huge or NaN values?)")
        ci, dist, dist_h = best
        idx.append(ci)
        sum0 = best_sum
    return zt[:, idx].T.contiguous()


def _assign(zt: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Each sample's nearest centre; the first on a tie (OpenCV's
    `min_dist > dist`)."""
    best = _sqdist(zt, centers[0])
    label = torch.zeros(zt.shape[1], dtype=torch.int32, device=zt.device)
    for k in range(1, centers.shape[0]):
        d = _sqdist(zt, centers[k])
        closer = d < best
        best = torch.where(closer, d, best)
        label.masked_fill_(closer, k)
    return label


def _update_centers(z: np.ndarray, labels: np.ndarray, k: int) -> np.ndarray:
    """The new centres from `labels` (changed in place by the repair):
    float32 sums in sample order, an empty cluster repaired as OpenCV
    does, then each sum times float32 1 / count."""
    dims = z.shape[1]
    sums = np.zeros((k, dims), np.float32)
    counts = np.zeros(k, np.int64)
    for c in range(k):
        rows = z[labels == c]
        counts[c] = len(rows)
        if len(rows):
            sums[c] = np.cumsum(rows, axis=0, dtype=np.float32)[-1]
    for c in range(k):
        if counts[c]:
            continue
        # take the farthest point of the largest cluster (the first of the
        # largest; the last of the farthest) into the empty one
        big = int(np.argmax(counts))
        base = sums[big] * (np.float32(1) / np.float32(counts[big]))
        members = np.flatnonzero(labels == big)
        t = z[members] - base
        d = t[:, 0] * t[:, 0]
        for j in range(1, dims):
            d = d + t[:, j] * t[:, j]
        far = members[len(d) - 1 - int(np.argmax(d[::-1]))]
        counts[big] -= 1
        counts[c] += 1
        labels[far] = c
        sums[big] = sums[big] - z[far]
        sums[c] = sums[c] + z[far]
    scale = np.float32(1) / counts.astype(np.float32)
    return sums * scale[:, None]


def kmeans_pp(z: ImageLike, k: int, max_iter: int = 10, eps: float = 1.0, attempts: int = 3,
              rng: Optional[OpenCVRNG] = None, device=None) -> np.ndarray:
    """`cv2.kmeans(z, k, None, (EPS + MAX_ITER, max_iter, eps), attempts,
    KMEANS_PP_CENTERS)`'s labels, int32 (N,), drawing from `rng` (None:
    `DEFAULT_RNG`) exactly as OpenCV draws from its thread's RNG.

    The distance passes run on `device` (None: cuda) in float32. The centre
    sums and the k-means++ walk and sums run on the host: OpenCV adds in
    sample order, and no reduction on the card adds in that order, so a
    card sum would round differently and move a label or a seed."""
    rng = DEFAULT_RNG if rng is None else rng
    dev = resolve_device(device)
    zd = torch.as_tensor(z).to(dev, torch.float32)
    zt = zd.T.contiguous()
    zh = zd.cpu().numpy()
    n = zh.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"kmeans: k = {k} for {n} samples")
    eps2 = max(eps, 0.0) ** 2
    max_count = min(max(max_iter, 2), 100)
    best_compactness, best_labels = math.inf, None
    for _ in range(max(attempts, 1)):
        centers = _centers_pp(zt, k, rng)
        labels = _assign(zt, centers).cpu().numpy()
        it = 1
        while True:
            old = centers.cpu().numpy()
            new = _update_centers(zh, labels, k)
            shift = 0.0
            for c in range(k):
                dist = 0.0
                for j in range(new.shape[1]):
                    t = float(new[c, j] - old[c, j])
                    dist += t * t
                shift = max(shift, dist)
            centers = torch.as_tensor(new, device=dev)
            it += 1
            if it == max_count or shift <= eps2:
                # the last pass measures and reassigns nothing
                lab = torch.as_tensor(labels, device=dev, dtype=torch.int64)
                compactness = _cv_sum(_sqdist(zt, centers.T[:, lab]).cpu().numpy())
                break
            labels = _assign(zt, centers).cpu().numpy()
        if compactness < best_compactness:
            best_compactness, best_labels = compactness, labels.copy()
    return best_labels.astype(np.int32)


# --- connected components -----------------------------------------------------------------


def connected_components(mask: np.ndarray) -> Tuple[int, np.ndarray]:
    """`cv2.connectedComponents(mask)` (8-connectivity): (count with the
    background, int32 labels). scipy labels the components on the host;
    they are then numbered as OpenCV's block-based scan numbers them, by
    the first 2x2 block (row // 2, col // 2) each touches in block-raster
    order (two 8-connected components never share a block). The host,
    because the k-means labels are there already and the masks are saved
    from there; a label propagation on the card would take as many passes
    as the longest component is winding."""
    from scipy import ndimage

    mask = np.asarray(mask) != 0
    lab, num = ndimage.label(mask, structure=np.ones((3, 3), bool))
    h, w = mask.shape
    rows, cols = np.indices((h, w))
    key = (rows // 2) * ((w + 1) // 2) + cols // 2
    first = ndimage.minimum(key, lab, index=np.arange(1, num + 1))
    rank = np.empty(num + 1, np.int32)
    rank[0] = 0
    rank[1:][np.argsort(first, kind="stable")] = np.arange(1, num + 1, dtype=np.int32)
    return num + 1, rank[lab]
