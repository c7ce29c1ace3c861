"""Equirectangular -> perspective crops (counterpart of the JAX package's
data/equirect.py).

A 360-degree capture becomes pinhole crops that the normal SfM -> training
pipeline reads. `equirect_maps`, `sampling_pattern`, `crop_resolution`
and `_crop_pitch_bounds` are the JAX module's host numpy, unchanged.
`equirect_to_perspective` is the JAX module's `cv2.remap(img, map_x,
map_y, INTER_CUBIC, borderMode=BORDER_WRAP)` rebuilt bit for bit as torch
ops on the image's device. OpenCV 5 (the version the CPU tests hold it
to) interpolates float maps in float32, not on its 1/32-pixel fixed-point
table: the exact fraction of each map value, the cubic weights (A = -0.75)
in float32 with fused multiply-adds, a chain of fused multiply-adds over
each row of the 4 x 4 taps and then over the rows, rounded half to even
(`remap_cubic_wrap`; held to cv2 in tests/test_torch_tools.py for maps
within one image period of the image, as the crops' maps are). Every fused
multiply-add is emulated as a float64 product and sum rounded once to
float32 (`undistort._fma32`), one IEEE operation at a time, so the CPU and
the card give the same bits. The port keeps RGB throughout: an RGB crop of
an RGB image holds the bytes cv2 gives for the BGR one, channel for
channel, and `generate_planar_projections` writes crops as `cv2.imwrite`
does (`write_jpeg` at quality 95).

Conventions (the reference's): the camera looks down +x, +y right, +z up;
yaw rotates about +z, pitch about the yawed +y axis; lon in [-180, 180]
maps linearly onto the width, lat in [-90, 90] onto the height (row 0 is
lat +90).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gaussiangrasper_torch.data.undistort import _fma32
from gaussiangrasper_torch.utils.image_io import read_image, write_jpeg


def _axis_angle(axis: np.ndarray, theta: float) -> np.ndarray:
    """3x3 rotation about `axis` by `theta` (Euler-Rodrigues, with the
    reference's negated sine term)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    a = math.cos(theta / 2.0)
    b, c, d = -axis * math.sin(theta / 2.0)
    return np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c + a * d), 2 * (b * d - a * c)],
        [2 * (b * c - a * d), a * a + c * c - b * b - d * d, 2 * (c * d + a * b)],
        [2 * (b * d + a * c), 2 * (c * d - a * b), a * a + d * d - b * b - c * c],
    ])


def equirect_maps(equ_size: Tuple[int, int], fov_deg: float, yaw_deg: float, pitch_deg: float,
                  out_size: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """float32 (H_out, W_out) maps (map_x, map_y) from a perspective crop
    into an equirect image of (H_eq, W_eq); fov_deg is the horizontal field
    of view, the vertical follows the aspect ratio; map_x wraps at the
    +-180 degree seam."""
    equ_h, equ_w = equ_size
    hd, wd = out_size
    w_len = 2.0 * math.tan(math.radians(fov_deg) / 2.0)
    h_len = w_len * hd / wd
    y = (np.arange(wd, dtype=np.float64) - wd / 2.0) * (w_len / wd)
    z = -(np.arange(hd, dtype=np.float64) - hd / 2.0) * (h_len / hd)
    yy, zz = np.meshgrid(y, z)
    xyz = np.stack([np.ones_like(yy), yy, zz], axis=-1)
    xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)

    r1 = _axis_angle(np.array([0.0, 0.0, 1.0]), math.radians(yaw_deg))
    r2 = _axis_angle(r1 @ np.array([0.0, 1.0, 0.0]), math.radians(-pitch_deg))
    xyz = xyz @ (r2 @ r1).T

    lon = np.degrees(np.arctan2(xyz[..., 1], xyz[..., 0]))
    lat = -np.degrees(np.arcsin(np.clip(xyz[..., 2], -1.0, 1.0)))
    map_x = (lon / 180.0) * (equ_w / 2.0) + equ_w / 2.0
    map_y = (lat / 90.0) * (equ_h / 2.0) + equ_h / 2.0
    return map_x.astype(np.float32), map_y.astype(np.float32)


def _cubic_weights(t: torch.Tensor) -> list:
    """The four cubic weights (A = -0.75) at float32 fractions t, as
    OpenCV 5 computes them: with s = 1 - t, w0 = A (t s^2), w3 = A (s t^2),
    w1 = fma(fma(A + 2, t, -(A + 3)), t^2, 1), w2 = 1 - w0 - w1 - w3."""
    s = 1.0 - t
    w0 = -0.75 * (t * (s * s))
    w3 = -0.75 * (s * (t * t))
    w1 = _fma32(_fma32(torch.full_like(t, 1.25), t, torch.full_like(t, -2.25)), t * t,
                torch.ones_like(t))
    return [w0, w1, (1.0 - w0) - w1 - w3, w3]


def _fma_sum(values: list, weights: list) -> torch.Tensor:
    """v0 w0, then fma(v_k, w_k, sum) for k = 1..3, in float32."""
    acc = values[0] * weights[0]
    for v, w in zip(values[1:], weights[1:]):
        acc = _fma32(v, w, acc)
    return acc


def remap_cubic_wrap(img: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor) -> torch.Tensor:
    """cv2.remap(INTER_CUBIC, BORDER_WRAP) of a uint8 (H, W, C) image on
    float32 maps (h, w), as OpenCV 5 computes it for float maps, on the
    image's device: the taps from one pixel left of and above floor(map),
    wrapped on both axes; each row's four taps summed with the horizontal
    weights by a chain of float32 fused multiply-adds, then the four rows
    with the vertical ones; rounded half to even and saturated to uint8."""
    H, W = img.shape[:2]
    fx, fy = torch.floor(map_x), torch.floor(map_y)
    wx = [w[..., None] for w in _cubic_weights(map_x - fx)]
    wy = [w[..., None] for w in _cubic_weights(map_y - fy)]
    sx, sy = fx.to(torch.int64) - 1, fy.to(torch.int64) - 1
    cols = [torch.remainder(sx + k, W) for k in range(4)]
    rows = []
    for j in range(4):
        r = torch.remainder(sy + j, H)
        rows.append(_fma_sum([img[r, c].to(torch.float32) for c in cols], wx))
    return torch.round(_fma_sum(rows, wy)).clamp(0, 255).to(torch.uint8)


def equirect_to_perspective(img, fov_deg: float, yaw_deg: float, pitch_deg: float,
                            out_size: Tuple[int, int]) -> torch.Tensor:
    """One perspective crop (H_out, W_out[, C]) out of a uint8 equirect
    image (H, W[, C]) (numpy or a tensor; a tensor stays on its device).
    Bicubic, wrapping across the longitude seam and the poles as
    BORDER_WRAP does."""
    src = torch.as_tensor(img)
    if src.dtype != torch.uint8:
        raise TypeError(f"equirect_to_perspective takes a uint8 image, got {src.dtype}")
    grey = src.ndim == 2
    if grey:
        src = src[..., None]
    mx, my = equirect_maps(tuple(src.shape[:2]), fov_deg, yaw_deg, pitch_deg, out_size)
    out = remap_cubic_wrap(src, torch.as_tensor(mx, device=src.device),
                           torch.as_tensor(my, device=src.device))
    return out[..., 0] if grey else out


def _crop_pitch_bounds(bounds: List[Optional[float]], fov: float,
                       crop_factor: Sequence[float]) -> List[Optional[float]]:
    """The ascending pitch rows under top / bottom crop factors: rows
    whose frustum lies inside the cropped band are dropped (None), the
    first partly covered row moves onto the crop boundary and the shift
    halves across the remaining rows."""
    top, bottom = crop_factor[0], crop_factor[1]
    if bottom > 0:
        start = 90.0 - 180.0 * bottom - fov / 2.0
        for i in reversed(range(len(bounds))):
            el = bounds[i]
            if el is None:
                continue
            if el > start + fov / 2.0:
                bounds[i] = None
            elif el > start:
                diff = el - start
                bounds[i] = start
                for j in range(i - 1, -1, -1):
                    if bounds[j] is not None:
                        bounds[j] -= diff / (2 ** (i - j))
                break
    if top > 0:
        start = -90.0 + 180.0 * top + fov / 2.0
        for i, el in enumerate(bounds):
            if el is None:
                continue
            if el < start - fov / 2.0:
                bounds[i] = None
            elif el < start:
                diff = start - el
                bounds[i] = start
                for j in range(i + 1, len(bounds)):
                    if bounds[j] is not None:
                        bounds[j] += diff / (2 ** (j - i))
                break
    return bounds


def sampling_pattern(samples_per_im: int, crop_factor: Sequence[float] = (0.0, 0.0, 0.0, 0.0)
                     ) -> Tuple[float, List[Tuple[float, float]]]:
    """(fov_deg, [(yaw, pitch), ...]): 8 crops at fov 120 (the equator
    every 90 degrees, +-45 rows every 180) or 14 at fov 110 (every 60 and
    90). crop_factor = (top, bottom, left, right) fractions in [0, 1]."""
    if any(not 0.0 <= f <= 1.0 for f in crop_factor):
        raise ValueError("crop_factor values must be in [0, 1]")
    left_bound, right_bound = -180.0, 180.0
    if crop_factor[3] > 0:
        left_bound = -180.0 + 360.0 * crop_factor[3]
    if crop_factor[2] > 0:
        right_bound = 180.0 - 360.0 * crop_factor[2]

    if samples_per_im == 8:
        fov, mid_step, pole_step = 120.0, 90.0, 180.0
    elif samples_per_im == 14:
        fov, mid_step, pole_step = 110.0, 60.0, 90.0
    else:
        raise ValueError("samples_per_im must be 8 or 14")
    low, mid, high = _crop_pitch_bounds([-45.0, 0.0, 45.0], fov, crop_factor)

    pairs: List[Tuple[float, float]] = []
    if mid is not None:
        pairs += [(y, mid) for y in np.arange(left_bound, right_bound, mid_step)]
    if high is not None:
        pairs += [(y, high) for y in np.arange(left_bound, right_bound, pole_step)]
    if low is not None:
        pairs += [(y, low) for y in np.arange(left_bound, right_bound, pole_step)]
    return fov, pairs


def crop_resolution(equ_size: Tuple[int, int], num_crops: int) -> Tuple[int, int]:
    """Square crop side from num_crops * res^2 = H * W."""
    res = int(math.sqrt(equ_size[0] * equ_size[1] / num_crops))
    return res, res


def generate_planar_projections(image_dir: Path, out_size: Tuple[int, int], samples_per_im: int,
                                crop_factor: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                                device=None) -> Path:
    """Write `samples_per_im` crops of each equirect image in `image_dir`
    into image_dir/planar_projections/<stem>_<i>.jpg (quality 95, as
    cv2.imwrite); the resampling on `device` (None: the CPU)."""
    fov, pairs = sampling_pattern(samples_per_im, crop_factor)
    out_dir = Path(image_dir) / "planar_projections"
    out_dir.mkdir(exist_ok=True)
    n_images = 0
    for f in sorted(Path(image_dir).iterdir()):
        if f.suffix.lower() not in (".png", ".jpg", ".jpeg"):
            continue
        img = torch.as_tensor(_as_colour(read_image(f)), device=device)
        for i, (yaw, pitch) in enumerate(pairs):
            crop = equirect_to_perspective(img, fov, yaw, pitch, out_size)
            write_jpeg(out_dir / f"{f.stem}_{i}.jpg", crop.cpu().numpy(), quality=95)
        n_images += 1
    if n_images == 0:
        raise SystemExit(f"no images found in {image_dir}")
    print(f"wrote {n_images * len(pairs)} planar crops "
          f"({len(pairs)}/image, fov={fov:.0f}°) -> {out_dir}")
    return out_dir


def _as_colour(img: np.ndarray) -> np.ndarray:
    """What cv2.imread's default colour mode makes of a frame: grey
    repeated to three channels, alpha dropped."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, -1)
    return img[..., :3]
