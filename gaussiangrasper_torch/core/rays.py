"""Ray primitives and per-camera ray generation for the ray-marched
(NeRF-family) models (counterpart of the JAX package's core/rays.py).

Randomness is explicit. Every function that draws takes `rng`, which is
either a `torch.Generator` (the trainers' path: the draws come from it in a
fixed order) or a mapping from draw names to tensors of uniform or normal
values (the tests' path: the same numbers the JAX package draws from its
keys). `uniform` and `normal` below resolve one draw either way.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from gaussiangrasper_torch.core.cameras import Camera

Draws = Union[None, torch.Generator, Mapping[str, Any]]


def _draw(rng: Draws, name: str, shape: Sequence[int], device, dtype, fn) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    if isinstance(rng, torch.Generator):
        return fn(shape, generator=rng, device=device, dtype=dtype)
    if rng is None or name not in rng:
        raise KeyError(f"no draw {name!r} of shape {shape} (rng: {type(rng).__name__})")
    x = torch.as_tensor(rng[name], dtype=dtype, device=device)
    if tuple(x.shape) != shape:
        raise ValueError(f"draw {name!r} has shape {tuple(x.shape)}, want {shape}")
    return x


def uniform(rng: Draws, name: str, shape: Sequence[int], device=None,
            dtype=torch.float32) -> torch.Tensor:
    """U[0, 1) values of `shape`: from the generator, or rng[name]."""
    return _draw(rng, name, shape, device, dtype, torch.rand)


def normal(rng: Draws, name: str, shape: Sequence[int], device=None,
           dtype=torch.float32) -> torch.Tensor:
    """N(0, 1) values of `shape`: from the generator, or rng[name]."""
    return _draw(rng, name, shape, device, dtype, torch.randn)


class RayBundle(NamedTuple):
    origins: torch.Tensor     # (..., 3)
    directions: torch.Tensor  # (..., 3) unit
    pixel_area: torch.Tensor  # (..., 1)
    nears: Optional[torch.Tensor] = None
    fars: Optional[torch.Tensor] = None

    def map(self, fn) -> "RayBundle":
        return RayBundle(*(None if x is None else fn(x) for x in self))


class RaySamples(NamedTuple):
    positions: torch.Tensor   # (..., S, 3)
    directions: torch.Tensor  # (..., S, 3)
    starts: torch.Tensor      # (..., S, 1) bin starts along the ray
    ends: torch.Tensor        # (..., S, 1)

    @property
    def deltas(self) -> torch.Tensor:
        return self.ends - self.starts


VR_IPD = 0.064
"""Interpupillary distance in meters for the stereo camera models."""


def undistort_coords(dx: torch.Tensor, dy: torch.Tensor, distortion: torch.Tensor,
                     iters: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert the OpenCV radial (k1..k4) + tangential (p1, p2) model on
    normalized-plane coordinates by Newton steps with a forward-difference
    Jacobian."""
    k1, k2, k3, k4, p1, p2 = (distortion[i] for i in range(6))

    def residual(xu, yu):
        r2 = xu * xu + yu * yu
        d = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
        fx = d * xu + 2 * p1 * xu * yu + p2 * (r2 + 2 * xu * xu) - dx
        fy = d * yu + 2 * p2 * xu * yu + p1 * (r2 + 2 * yu * yu) - dy
        return fx, fy

    xu, yu = dx, dy
    eps = 1e-6
    for _ in range(iters):
        fx, fy = residual(xu, yu)
        fx_x, fy_x = residual(xu + eps, yu)
        fx_y, fy_y = residual(xu, yu + eps)
        a, b = (fx_x - fx) / eps, (fx_y - fx) / eps
        c, d = (fy_x - fy) / eps, (fy_y - fy) / eps
        det = a * d - b * c
        det = torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
        xu, yu = xu - (d * fx - b * fy) / det, yu - (-c * fx + a * fy) / det
    return xu, yu


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def generate_rays(camera: Camera, coords: Optional[torch.Tensor] = None,
                  camera_type: str = "perspective",
                  distortion=None) -> RayBundle:
    """Rays through pixel centers. coords: (..., 2) integer (row, col);
    default the full image grid. OpenGL convention: the camera looks down
    -z, y up.

    camera_type: "perspective", "fisheye" (equidistant), "equirectangular"
    (pixel grid = (longitude, latitude)), "omnidirectional_l" / "_r" (ODS:
    equirect directions, origins on an IPD/2 circle) and "vr180_l" / "_r"
    (half-sphere directions, a fixed horizontal eye offset).

    distortion: optional (6,) OpenCV params (k1 k2 k3 k4 p1 p2) inverted per
    ray for the perspective and fisheye models (not the panoramic ones)."""
    c2w = camera.camera_to_world
    dev = c2w.device
    if coords is None:
        ys, xs = torch.meshgrid(torch.arange(camera.height, device=dev),
                                torch.arange(camera.width, device=dev), indexing="ij")
        coords = torch.stack([ys, xs], dim=-1)
    coords = torch.as_tensor(coords, device=dev)
    y = coords[..., 0].to(c2w.dtype) + 0.5
    x = coords[..., 1].to(c2w.dtype) + 0.5
    r = c2w[:3, :3]
    origin = c2w[:3, 3]
    pixel_area = 1.0 / (camera.fx * camera.fy)

    if camera_type in ("omnidirectional_l", "omnidirectional_r", "vr180_l", "vr180_r"):
        cu = (x - camera.cx) / camera.fx
        cv = (y - camera.cy) / camera.fy
        is_vr180 = camera_type.startswith("vr180")
        theta = -math.pi * (cu / 2.0 if is_vr180 else cu)
        phi = math.pi * (0.5 - cv)
        dirs_cam = torch.stack([-torch.sin(theta) * torch.sin(phi), torch.cos(phi),
                                -torch.cos(theta) * torch.sin(phi)], dim=-1)
        side = 1.0 if camera_type.endswith("_r") else -1.0
        zeros = torch.zeros_like(theta)
        if is_vr180:
            local = torch.stack([torch.full_like(theta, side * VR_IPD / 2.0), zeros, zeros], -1)
        else:
            local = torch.stack([side * (VR_IPD / 2.0) * torch.cos(theta), zeros,
                                 -side * (VR_IPD / 2.0) * torch.sin(theta)], -1)
        dirs = _normalize(dirs_cam @ r.T)
        origins = local @ r.T + origin
        return RayBundle(origins=origins, directions=dirs,
                         pixel_area=pixel_area.expand(dirs[..., :1].shape))

    if camera_type == "equirectangular":
        lon = (x / camera.width - 0.5) * (2.0 * math.pi)
        lat = -(y / camera.height - 0.5) * math.pi
        dirs_cam = torch.stack([torch.cos(lat) * torch.sin(lon), torch.sin(lat),
                                -torch.cos(lat) * torch.cos(lon)], dim=-1)
    else:
        dx = (x - camera.cx) / camera.fx
        dy = -(y - camera.cy) / camera.fy
        if distortion is not None:
            dx, dy = undistort_coords(
                dx, dy, torch.as_tensor(distortion, dtype=c2w.dtype, device=dev))
        if camera_type == "fisheye":
            theta = torch.clamp(torch.sqrt(dx * dx + dy * dy), 1e-9, math.pi)
            sin_over_r = torch.sin(theta) / theta
            dirs_cam = torch.stack([dx * sin_over_r, dy * sin_over_r, -torch.cos(theta)], -1)
        else:
            dirs_cam = torch.stack([dx, dy, -torch.ones_like(dx)], dim=-1)
    dirs = _normalize(dirs_cam @ r.T)
    return RayBundle(origins=origin.expand(dirs.shape), directions=dirs,
                     pixel_area=pixel_area.expand(dirs[..., :1].shape))


def sample_along_rays(bundle: RayBundle, near: float, far: float, num_samples: int,
                      rng: Draws = None, stratified: bool = True,
                      name: str = "jitter") -> RaySamples:
    """Uniform samples, jittered within their bins when `stratified` and a
    draw source is given (draw `name`: (..., num_samples) uniforms)."""
    dev, dt = bundle.origins.device, bundle.origins.dtype
    t = torch.linspace(0.0, 1.0, num_samples + 1, device=dev, dtype=dt)
    bins = near + (far - near) * t
    shape = tuple(bundle.origins.shape[:-1]) + (num_samples,)
    starts = bins[:-1].expand(shape)
    ends = bins[1:].expand(shape)
    if stratified and rng is not None:
        mids = starts + (ends - starts) * uniform(rng, name, shape, dev, dt)
    else:
        mids = 0.5 * (starts + ends)
    pos = bundle.origins[..., None, :] + bundle.directions[..., None, :] * mids[..., None]
    dirs = bundle.directions[..., None, :].expand(pos.shape)
    return RaySamples(positions=pos, directions=dirs, starts=starts[..., None],
                      ends=ends[..., None])


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, num_samples: int, rng: Draws,
               name: str = "pdf_u") -> torch.Tensor:
    """Inverse-CDF resampling: (..., num_samples) ts from the bin edges
    (..., S+1) and their weights (..., S). Each u's bin is the count of CDF
    entries at or below it, as in the JAX package (not searchsorted)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, dim=-1)], dim=-1)
    u = uniform(rng, name, tuple(cdf.shape[:-1]) + (num_samples,), cdf.device, cdf.dtype)
    idx = torch.sum((u[..., None, :] >= cdf[..., :, None]).to(torch.int32), dim=-2)
    last = cdf.shape[-1] - 1
    below = torch.clamp(idx - 1, 0, last).to(torch.int64)
    above = torch.clamp(idx, 0, last).to(torch.int64)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bin_b = torch.gather(bins, -1, below)
    bin_a = torch.gather(bins, -1, above)
    diff = cdf_a - cdf_b
    denom = torch.where(diff < 1e-8, torch.ones_like(diff), diff)
    t = (u - cdf_b) / denom
    return bin_b + t * (bin_a - bin_b)


def render_weights(densities: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """w_i = T_i (1 - exp(-sigma_i d_i)) over the sample axis (-2)."""
    sd = densities * deltas
    alpha = 1.0 - torch.exp(-sd)
    trans = torch.exp(-torch.cat([torch.zeros_like(sd[..., :1, :]),
                                  torch.cumsum(sd, dim=-2)[..., :-1, :]], dim=-2))
    return alpha * trans


def composite(weights: torch.Tensor, values: torch.Tensor,
              background: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted sum along the sample axis, with an optional background."""
    out = torch.sum(weights * values, dim=-2)
    if background is not None:
        out = out + (1.0 - torch.sum(weights, dim=-2)) * background
    return out
