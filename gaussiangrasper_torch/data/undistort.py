"""Lens undistortion of a cached view: OpenCV's functions, as the JAX
package's `data/manager.undistort_image` calls them, in float64 Python
arithmetic (the new camera matrix) and plain torch ops (the per-pixel maps
and the resampling) on any device.

Perspective views (OpenCV's k1, k2, p1, p2, k3):

  * `optimal_new_camera_matrix` is `cv2.getOptimalNewCameraMatrix(K, d,
    size, alpha=0)`: a 9 x 9 grid over the image's pixel centres is
    undistorted by 5 fixed-point iterations, the largest rectangle inside it
    is mapped onto the image.
  * `cv2.undistort(img, K, d, None, newK)` builds its maps in stripes of
    max(1, 4096 // width) rows, each with the new camera's cy shifted by the
    stripe's first row (`undistort_maps_fixed`), rounds them to 1/32 pixel (CV_16SC2
    maps) and resamples with 15-bit fixed-point weights (`remap_fixed`).

Fisheye views (`camera_type == "fisheye"`, OpenCV's k1..k4 = d[0, 1, 4, 5]):

  * `fisheye_new_camera_matrix` is
    `cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(K, d, size, I,
    balance=0)`: the four edge midpoints undistorted by Newton's method.
  * `fisheye_rectify_map` is `cv2.fisheye.initUndistortRectifyMap(...,
    CV_32FC1)` and `remap_float` is `cv2.remap(INTER_LINEAR)` on float maps,
    which OpenCV 5 interpolates in float32 (two horizontal lerps and a
    vertical one, each a fused multiply-add, rounded half to even).

Every map is computed in float64; every operation is one IEEE operation
(no fused kernels, no library reductions), so the CPU and the card give the
same bits. Pixels whose 2 x 2 footprint leaves the image take 0 for the
taps outside it (OpenCV's constant border). Held stage by stage against
OpenCV in tests/test_torch_undistort.py.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

F64 = torch.float64
INTER_BITS = 5                      # OpenCV's INTER_BITS: 1/32-pixel cells
INTER_TAB = 1 << INTER_BITS
COEF_BITS = 15                      # INTER_REMAP_COEF_BITS
UNDISTORT_ITERS = 5                 # cvUndistortPoints' default TermCriteria(COUNT, 5)
FISHEYE_ITERS, FISHEYE_EPS = 10, 1e-8  # fisheye::undistortPoints' default criteria


def _inv3(m) -> list:
    """cv::invert(DECOMP_LU) of a 3 x 3 double matrix: the adjugate over
    the determinant, term by term as OpenCV writes it."""
    (a, b, c), (d_, e, f), (g, h, i) = [[float(x) for x in row] for row in m]
    det = a * (e * i - f * h) - b * (d_ * i - f * g) + c * (d_ * h - e * g)
    r = 1.0 / det
    return [(e * i - f * h) * r, (c * h - b * i) * r, (b * f - c * e) * r,
            (f * g - d_ * i) * r, (a * i - c * g) * r, (c * d_ - a * f) * r,
            (d_ * h - e * g) * r, (b * g - a * h) * r, (a * e - b * d_) * r]


def _undistort_point(u: float, v: float, k: np.ndarray, d: np.ndarray) -> Tuple[float, float]:
    """cvUndistortPointsInternal for one point, no R and no P: normalized
    undistorted coordinates after UNDISTORT_ITERS iterations."""
    fx, fy, cx, cy = float(k[0, 0]), float(k[1, 1]), float(k[0, 2]), float(k[1, 2])
    k1, k2, p1, p2, k3 = (float(x) for x in d)
    ifx, ify = 1.0 / fx, 1.0 / fy
    x0 = x = (u - cx) * ifx
    y0 = y = (v - cy) * ify
    for _ in range(UNDISTORT_ITERS):
        r2 = x * x + y * y
        icdist = 1.0 / (1 + ((k3 * r2 + k2) * r2 + k1) * r2)
        if icdist < 0:
            return (u - cx) * ifx, (v - cy) * ify
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    return x, y


def optimal_new_camera_matrix(k: np.ndarray, d: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.getOptimalNewCameraMatrix(k, d, (width, height), alpha=0)[0]."""
    w, h = size
    n = 9
    ix0, ix1, iy0, iy1 = -3.4028234663852886e38, 3.4028234663852886e38, \
        -3.4028234663852886e38, 3.4028234663852886e38  # +-FLT_MAX
    for gy in range(n):
        for gx in range(n):
            px, py = _undistort_point(gx * (w - 1) / (n - 1), gy * (h - 1) / (n - 1), k, d)
            if gx == 0:
                ix0 = max(ix0, px)
            if gx == n - 1:
                ix1 = min(ix1, px)
            if gy == 0:
                iy0 = max(iy0, py)
            if gy == n - 1:
                iy1 = min(iy1, py)
    fx0 = (w - 1) / (ix1 - ix0)
    fy0 = (h - 1) / (iy1 - iy0)
    return np.array([[fx0, 0.0, -fx0 * ix0], [0.0, fy0, -fy0 * iy0], [0.0, 0.0, 1.0]])


def _fisheye_undistort_point(u: float, v: float, k: np.ndarray, d: np.ndarray):
    """fisheye::undistortPoints for one point, no R and no P."""
    pw0 = (u - float(k[0, 2])) / float(k[0, 0])
    pw1 = (v - float(k[1, 2])) / float(k[1, 1])
    theta_d = math.sqrt(pw0 * pw0 + pw1 * pw1)
    theta_d = min(max(-math.pi / 2.0, theta_d), math.pi / 2.0)
    theta, scale, converged = theta_d, 0.0, False
    if abs(theta_d) > FISHEYE_EPS:
        k0, k1, k2, k3 = (float(x) for x in d)
        for _ in range(FISHEYE_ITERS):
            t2 = theta * theta
            t4 = t2 * t2
            t6 = t4 * t2
            t8 = t6 * t2
            a, b, c, e = k0 * t2, k1 * t4, k2 * t6, k3 * t8
            fix = (theta * (1 + a + b + c + e) - theta_d) / (1 + 3 * a + 5 * b + 7 * c + 9 * e)
            theta = theta - fix
            if abs(fix) < FISHEYE_EPS:
                converged = True
                break
        scale = math.tan(theta) / theta_d
    else:
        converged = True
    flipped = (theta_d < 0 < theta) or (theta < 0 < theta_d)
    if converged and not flipped:
        return pw0 * scale, pw1 * scale
    return -1000000.0, -1000000.0


def fisheye_new_camera_matrix(k: np.ndarray, d: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.fisheye.estimateNewCameraMatrixForUndistortRectify(k, d, (width,
    height), np.eye(3), balance=0)."""
    w, h = size
    pts = [list(_fisheye_undistort_point(float(u), float(v), k, d))
           for u, v in ((w // 2, 0), (w, h // 2), (w // 2, h), (0, h // 2))]
    sx = sy = 0.0
    for px, py in pts:  # cv::mean: a running sum, then * (1 / count)
        sx += px
        sy += py
    cn = [sx * (1.0 / 4), sy * (1.0 / 4)]
    aspect = float(k[0, 0]) / float(k[1, 1])
    cn[1] *= aspect
    for p in pts:
        p[1] *= aspect
    minx = min(p[0] for p in pts)
    maxx = max(p[0] for p in pts)
    miny = min(p[1] for p in pts)
    maxy = max(p[1] for p in pts)
    f = max(w * 0.5 / (cn[0] - minx), w * 0.5 / (maxx - cn[0]),
            h * 0.5 * aspect / (cn[1] - miny), h * 0.5 * aspect / (maxy - cn[1]))
    # balance 0: f = 0 * fmin + (1 - 0) * fmax
    cx, cy = -cn[0] * f + w * 0.5, -cn[1] * f + h * aspect * 0.5
    return np.array([[f, 0.0, cx], [0.0, f / aspect, cy / aspect], [0.0, 0.0, 1.0]])


def _pixel_grid(ir, width: int, rows: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The homogeneous ray of each map pixel: row i, column j gives
    (i * ir[1] + ir[2] + j * ir[0], ..., ...) for x, y and w. `ir` holds
    nine floats, or nine (rows, 1) float64 tensors (one inverse a row);
    `rows` is each row's index i, (rows, 1) float64."""
    j = torch.arange(width, dtype=F64, device=rows.device)[None, :]
    return ((rows * ir[1] + ir[2]) + j * ir[0], (rows * ir[4] + ir[5]) + j * ir[3],
            (rows * ir[7] + ir[8]) + j * ir[6])


def _lens_map(k: np.ndarray, d: np.ndarray, ir, width: int, rows: torch.Tensor):
    """initUndistortRectifyMap's source pixel (u, v), float64, for the rows
    `rows` under the inverse new camera `ir` (see `_pixel_grid`)."""
    X, Y, W = _pixel_grid(ir, width, rows)
    k1, k2, p1, p2, k3 = (float(x) for x in d)
    w = 1.0 / W
    x, y = X * w, Y * w
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    xy2 = 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    xd = x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * xy2
    return float(k[0, 0]) * xd + float(k[0, 2]), float(k[1, 1]) * yd + float(k[1, 2])


def rectify_map(k: np.ndarray, d: np.ndarray, new_k: np.ndarray, width: int, rows: int,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cv2.initUndistortRectifyMap(k, d, I, new_k, (width, rows)) before
    its conversion: the source pixel (u, v) of each destination pixel, in
    float64 (rows, width)."""
    i = torch.arange(rows, dtype=F64, device=device)[:, None]
    return _lens_map(k, d, _inv3(new_k), width, i)


def fixed_point(u: torch.Tensor) -> torch.Tensor:
    """A float64 map in 1/32 pixels: saturate_cast<int>(u * 32), rounded
    half to even, int64."""
    s = torch.round(u * INTER_TAB).clamp(-2.0 ** 31, 2.0 ** 31 - 1)
    return torch.nan_to_num(s, nan=0.0).to(torch.int64)


def undistort_maps_fixed(k: np.ndarray, d: np.ndarray, new_k: np.ndarray, width: int,
                         height: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cv2.undistort's maps in 1/32 pixels, int64 (height, width). OpenCV
    builds them in stripes of max(1, 4096 // width) rows, each with the new
    camera's cy shifted by the stripe's first row and rows counted from it;
    here every row carries its stripe's inverse and its index in the
    stripe, so one pass gives the same arithmetic for every stripe."""
    stripe = min(max(1, (1 << 12) // max(width, 1)), height)
    irs, local = [], []
    for y0 in range(0, height, stripe):
        ar = np.array(new_k, np.float64)
        ar[1, 2] = float(new_k[1, 2]) - y0
        n = min(stripe, height - y0)
        irs.extend([_inv3(ar)] * n)
        local.extend(range(n))
    ir = torch.tensor(irs, dtype=F64, device=device).T[..., None]  # 9 x (height, 1)
    rows = torch.tensor(local, dtype=F64, device=device)[:, None]
    u, v = _lens_map(k, d, ir, width, rows)
    return fixed_point(u), fixed_point(v)


def fisheye_rectify_map(k: np.ndarray, d: np.ndarray, new_k: np.ndarray, width: int,
                        height: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cv2.fisheye.initUndistortRectifyMap(k, d, I, new_k, (width, height),
    CV_32FC1): float32 (height, width) maps."""
    rows = torch.arange(height, dtype=F64, device=device)[:, None]
    X, Y, W = _pixel_grid(_inv3(new_k), width, rows)
    k0, k1, k2, k3 = (float(x) for x in d)
    x, y = X / W, Y / W
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan(r)
    t2 = theta * theta
    t4 = t2 * t2
    t6 = t4 * t2
    t8 = t4 * t4
    theta_d = theta * (1 + k0 * t2 + k1 * t4 + k2 * t6 + k3 * t8)
    scale = torch.where(r == 0, torch.ones_like(r), theta_d / r)
    u = float(k[0, 0]) * x * scale + float(k[0, 2])
    v = float(k[1, 1]) * y * scale + float(k[1, 2])
    behind = W <= 0
    inf = torch.full_like(u, math.inf)
    u = torch.where(behind, torch.where(X > 0, -inf, inf), u)
    v = torch.where(behind, torch.where(Y > 0, -inf, inf), v)
    return u.to(torch.float32), v.to(torch.float32)


def _taps(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor):
    """The 2 x 2 footprint at integer (sx, sy) of an (H, W, C) image, each
    tap (h, w, C) in the image's dtype, 0 where it falls outside."""
    H, W = img.shape[:2]
    out = []
    for dy in (0, 1):
        for dx in (0, 1):
            x, y = sx + dx, sy + dy
            ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
            v = img[y.clamp(0, H - 1), x.clamp(0, W - 1)]
            out.append(torch.where(ok[..., None], v, torch.zeros_like(v)))
    return out


def remap_fixed(img: torch.Tensor, iu: torch.Tensor, iv: torch.Tensor) -> torch.Tensor:
    """cv2.remap(INTER_LINEAR, BORDER_CONSTANT 0) of a uint8 (H, W, C)
    image on CV_16SC2 maps (iu, iv in 1/32 pixels): 15-bit weights
    (32 - a)(32 - b) ... scaled by 32, the sum rounded by + 2^14 >> 15."""
    iu = ((iu + 2 ** 20) % 2 ** 21) - 2 ** 20  # (short)(iu >> 5) wraps like int16
    iv = ((iv + 2 ** 20) % 2 ** 21) - 2 ** 20
    sx, sy = iu >> INTER_BITS, iv >> INTER_BITS
    ax, ay = (iu & (INTER_TAB - 1))[..., None], (iv & (INTER_TAB - 1))[..., None]
    p00, p01, p10, p11 = (t.to(torch.int64) for t in _taps(img, sx, sy))
    b = INTER_TAB
    acc = (p00 * ((b - ay) * (b - ax)) + p01 * ((b - ay) * ax) + p10 * (ay * (b - ax))
           + p11 * (ay * ax)) * ((1 << COEF_BITS) // (b * b))
    return ((acc + (1 << (COEF_BITS - 1))) >> COEF_BITS).clamp(0, 255).to(torch.uint8)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once: the product of two float32 is exact
    in float64, the sum is rounded to float64 and then to float32."""
    return (a.to(F64) * b.to(F64) + c.to(F64)).to(torch.float32)


def remap_float(img: torch.Tensor, mx: torch.Tensor, my: torch.Tensor) -> torch.Tensor:
    """cv2.remap(INTER_LINEAR, BORDER_CONSTANT 0) of a uint8 (H, W, C)
    image on float32 maps, as OpenCV 5 computes it: alpha = x - floor(x),
    two horizontal lerps and a vertical one (fused multiply-adds in
    float32), rounded half to even and saturated."""
    big = float(1 << 24)
    ok = torch.isfinite(mx) & torch.isfinite(my)
    mx = torch.where(ok, mx, torch.full_like(mx, -big)).clamp(-big, big)
    my = torch.where(ok, my, torch.full_like(my, -big)).clamp(-big, big)
    fx, fy = torch.floor(mx), torch.floor(my)
    alpha, beta = (mx - fx)[..., None], (my - fy)[..., None]
    p00, p01, p10, p11 = (t.to(torch.float32)
                          for t in _taps(img, fx.to(torch.int64), fy.to(torch.int64)))
    top = _fma32(alpha, p01 - p00, p00)
    bottom = _fma32(alpha, p11 - p10, p10)
    v = _fma32(beta, bottom - top, top)
    return torch.round(v).clamp(0, 255).to(torch.uint8)


def undistort(img: torch.Tensor, k: np.ndarray, distortion: np.ndarray,
              fisheye: bool) -> Tuple[torch.Tensor, np.ndarray]:
    """Undistort a uint8 (H, W) or (H, W, C) image on its own device.
    `distortion` is the parser's 6-vector (k1, k2, p1, p2, k3, k4; a
    fisheye view's k1..k4 are entries 0, 1, 4, 5). Returns (the image,
    the new 3 x 3 camera matrix)."""
    if img.dtype != torch.uint8:
        raise TypeError(f"undistort takes a uint8 image, got {img.dtype}")
    grey = img.ndim == 2
    src = img[..., None] if grey else img
    h, w = src.shape[:2]
    d = np.asarray(distortion, np.float64)
    k = np.asarray(k, np.float64)
    if fisheye:
        d4 = d[[0, 1, 4, 5]]
        new_k = fisheye_new_camera_matrix(k, d4, (w, h))
        mx, my = fisheye_rectify_map(k, d4, new_k, w, h, src.device)
        out = remap_float(src, mx, my)
    else:
        d5 = d[:5]
        new_k = optimal_new_camera_matrix(k, d5, (w, h))
        iu, iv = undistort_maps_fixed(k, d5, new_k, w, h, src.device)
        out = remap_fixed(src, iu, iv)
    return (out[..., 0] if grey else out), new_k
