"""The nerfacto reference: the pinhole camera, rays, the proposal sampler
and its losses, the hash-grid field, render_rays and one training step.

Frozen copies from gaussiangrasper_torch at commit d90391f:
core/cameras.py (Camera), core/sh.py (the basis), core/rays.py
(_draw, uniform, RayBundle, generate_rays for pinhole cameras,
sample_pdf, render_weights, composite), models/encodings.py,
models/efd.py (MLP), models/proposal.py, models/nerf.py (NerfConfig,
ProposalField, NerfField for the nerfacto field with proposal sampling
and per-image appearance embeddings, _x01, _with_appearance, _field,
_appearance_vec, _proposal_density, _points, _outputs, _render_proposal),
engine/optimizers.py (_adam), engine/nerf_trainer.py (loss_weights,
nerf_loss, nerf_step) and data/pixel_samplers.py (PixelSampler). Changed:
only the nerfacto field and its proposal renderer are kept, the
full_f32 blocks are gone (the caller sets the precision: `precision`),
and render_rays / nerf_step hand back the proposal weights and the
render's outputs for the check.
Plain PyTorch; imports nothing of gaussiangrasper_torch or JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

Draws = Union[None, torch.Generator, Mapping[str, Any]]
B1, B2 = 0.9, 0.999
ADAM_EPS = 1e-8

# --- from gaussiangrasper_torch/core/cameras.py ---

@dataclasses.dataclass(frozen=True)
class Camera:
    fx: torch.Tensor  # 0-d float32
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    camera_to_world: torch.Tensor  # (3, 4) OpenGL c2w
    width: int
    height: int

    @classmethod
    def create(cls, fx, fy, cx, cy, camera_to_world, width: int, height: int,
               device: Optional[Union[str, torch.device]] = None) -> "Camera":
        def f32(v):
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        return cls(fx=f32(fx), fy=f32(fy), cx=f32(cx), cy=f32(cy),
                   camera_to_world=f32(camera_to_world),
                   width=int(width), height=int(height))

    def rescale(self, scale: float) -> "Camera":
        """Rescaled output resolution; width/height floor, as the JAX
        package and the reference's `rescale_output_resolution` do."""
        return Camera(
            fx=self.fx * scale, fy=self.fy * scale,
            cx=self.cx * scale, cy=self.cy * scale,
            camera_to_world=self.camera_to_world,
            width=int(self.width * scale), height=int(self.height * scale),
        )

    @property
    def origin(self) -> torch.Tensor:
        return self.camera_to_world[:3, 3]

# --- from gaussiangrasper_torch/core/sh.py ---

_C0 = 0.28209479177387814


_C1 = 0.4886025119029199


_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)


_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)


_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def sh_basis(dirs: torch.Tensor) -> torch.Tensor:
    """All 25 real SH basis functions at unit directions (..., 3) -> (..., 25)."""
    x, y, z = dirs.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    one = torch.ones_like(x)
    bases = [
        _C0 * one,
        -_C1 * y,
        _C1 * z,
        -_C1 * x,
        _C2[0] * xy,
        _C2[1] * yz,
        _C2[2] * (2.0 * zz - xx - yy),
        _C2[3] * xz,
        _C2[4] * (xx - yy),
        _C3[0] * y * (3.0 * xx - yy),
        _C3[1] * xy * z,
        _C3[2] * y * (4.0 * zz - xx - yy),
        _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
        _C3[4] * x * (4.0 * zz - xx - yy),
        _C3[5] * z * (xx - yy),
        _C3[6] * x * (xx - 3.0 * yy),
        _C4[0] * xy * (xx - yy),
        _C4[1] * yz * (3.0 * xx - yy),
        _C4[2] * xy * (7.0 * zz - 1.0),
        _C4[3] * yz * (7.0 * zz - 3.0),
        _C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
        _C4[5] * xz * (7.0 * zz - 3.0),
        _C4[6] * (xx - yy) * (7.0 * zz - 1.0),
        _C4[7] * xz * (xx - 3.0 * yy),
        _C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
    ]
    return torch.stack(bases, dim=-1)


def num_sh_bases(degree: int) -> int:
    return (degree + 1) ** 2

# --- from gaussiangrasper_torch/core/rays.py ---

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


class RayBundle(NamedTuple):
    origins: torch.Tensor     # (..., 3)
    directions: torch.Tensor  # (..., 3) unit
    pixel_area: torch.Tensor  # (..., 1)
    nears: Optional[torch.Tensor] = None
    fars: Optional[torch.Tensor] = None

    def map(self, fn) -> "RayBundle":
        return RayBundle(*(None if x is None else fn(x) for x in self))


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

# --- from gaussiangrasper_torch/models/encodings.py ---

_PRIMES = (1, 2654435761, 805459861)


_U32 = 0xFFFFFFFF


_OFFSETS = tuple((i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1))


def sh_encoding(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Direction encoding by the real SH basis up to `degree`."""
    return sh_basis(dirs)[..., : num_sh_bases(degree)]


def grid_resolutions(num_levels: int, base_res: int, max_res: int) -> torch.Tensor:
    """floor(base_res * growth^l), growth = (max_res / base_res)^(1/(L-1)).

    Evaluated in float64 (with a 1e-9 relative guard for the levels whose
    value is an integer, the last one = max_res among them) and returned in
    float32. The JAX package evaluates it in float32, where exp can land an
    ulp below an integer and floor drops a level by one; at the JAX
    package's registered grids (4, 5, 12 and 16 levels up to 256 / 2048)
    both give the same resolutions, and converted params carry the JAX
    package's own buffer."""
    ratio = math.log(max_res / base_res) / max(num_levels - 1, 1) if num_levels > 1 else 0.0
    res = [math.floor(base_res * math.exp(ratio * level) * (1.0 + 1e-9))
           for level in range(num_levels)]
    return torch.tensor(res, dtype=torch.float32)


class HashGrid(nn.Module):
    """The hash table `table` (L, 2^H, F), a parameter, and the per-level
    `resolutions` (L,), a buffer (the lookup does not differentiate it)."""

    def __init__(self, num_levels: int = 16, features_per_level: int = 2,
                 log2_hashmap_size: int = 19, base_res: int = 16, max_res: int = 2048,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        shape = (num_levels, 2 ** log2_hashmap_size, features_per_level)
        # U(-1e-4, 1e-4)
        self.table = nn.Parameter((torch.rand(shape, generator=generator) * 2.0 - 1.0) * 1e-4)
        self.register_buffer("resolutions", grid_resolutions(num_levels, base_res, max_res))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hash_grid_encode(self, x)


def hash_indices(x: torch.Tensor, resolutions: torch.Tensor, hashmap_size: int):
    """(L, N, 8) int64 table rows of each point's 8 corners at each level
    and (L, N, 3) fractional positions, for x (N, 3) in [0, 1].

    The JAX package multiplies uint32 corners by the primes and XORs them,
    wrapping mod 2^32; here each product is taken in int64 (corner < 2^12,
    prime < 2^32) and masked to 32 bits, which gives the same bits."""
    pos = x[None] * resolutions[:, None, None]  # (L, N, 3)
    p0 = torch.floor(pos)
    frac = pos - p0
    offs = torch.tensor(_OFFSETS, dtype=torch.int64, device=x.device)
    corners = p0.to(torch.int64)[:, :, None, :] + offs  # (L, N, 8, 3)
    h = ((corners[..., 0] * _PRIMES[0]) & _U32) \
        ^ ((corners[..., 1] * _PRIMES[1]) & _U32) \
        ^ ((corners[..., 2] * _PRIMES[2]) & _U32)
    return h % hashmap_size, frac


def hash_grid_encode(grid: HashGrid, x: torch.Tensor) -> torch.Tensor:
    """Trilinear-interpolated hash lookup: x (..., 3) in [0, 1] ->
    (..., L * F)."""
    table = grid.table
    num_levels, hashmap_size, f = table.shape
    batch = x.shape[:-1]
    xf = x.reshape(-1, 3)
    h, frac = hash_indices(xf, grid.resolutions.detach(), hashmap_size)
    rows = h + (torch.arange(num_levels, device=x.device) * hashmap_size)[:, None, None]
    vals = table.reshape(num_levels * hashmap_size, f)[rows]  # (L, N, 8, F)
    offs = torch.tensor(_OFFSETS, device=x.device)
    axis_w = torch.where(offs == 1, frac[:, :, None, :], 1.0 - frac[:, :, None, :])
    w = axis_w[..., 0] * axis_w[..., 1] * axis_w[..., 2]  # (L, N, 8)
    feats = torch.sum(vals * w[..., None], dim=2)  # (L, N, F)
    return feats.permute(1, 0, 2).reshape(*batch, num_levels * f)

# --- from gaussiangrasper_torch/models/efd.py ---

class MLP(nn.Module):
    """Linear-ReLU-...-Linear with the JAX package's `init_mlp` layout: the
    parameters are `w{i}` (d_in, d_out) and `b{i}`, so a JAX MLP's arrays
    load by name, untransposed. Used by the ray-marched fields."""

    def __init__(self, in_dim: int, out_dim: int, hidden: Sequence[int] = (),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_dim, *hidden, out_dim]
        self.num_layers = len(dims) - 1
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            # torch.nn.Linear's default, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
            # for weights and bias alike
            bound = 1.0 / float(np.sqrt(d_in))
            w = (torch.rand((d_in, d_out), generator=generator) * 2.0 - 1.0) * bound
            b = (torch.rand((d_out,), generator=generator) * 2.0 - 1.0) * bound
            self.register_parameter(f"w{i}", nn.Parameter(w))
            self.register_parameter(f"b{i}", nn.Parameter(b))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = x @ getattr(self, f"w{i}") + getattr(self, f"b{i}")
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return x

# --- from gaussiangrasper_torch/models/proposal.py ---

def outer_weights(t_env: torch.Tensor, w_env: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """For each query interval of t (..., S+1), the total proposal weight
    w_env (..., Sp) of the proposal bins t_env (..., Sp+1) it overlaps:
    (..., S). Interval starts search on the left side, ends on the right."""
    cw = torch.cat([torch.zeros_like(w_env[..., :1]), torch.cumsum(w_env, dim=-1)], dim=-1)
    flat_env = t_env.reshape(-1, t_env.shape[-1]).contiguous()
    flat_cw = cw.reshape(-1, cw.shape[-1])
    flat_t = t.reshape(-1, t.shape[-1])
    last = flat_cw.shape[-1] - 1
    lo = torch.searchsorted(flat_env, flat_t[:, :-1].contiguous(), right=False)
    hi = torch.searchsorted(flat_env, flat_t[:, 1:].contiguous(), right=True)
    lo = torch.clamp(lo - 1, 0, last)
    hi = torch.clamp(hi, 0, last)
    out = torch.gather(flat_cw, 1, hi) - torch.gather(flat_cw, 1, lo)
    return out.reshape(tuple(t.shape[:-1]) + (t.shape[-1] - 1,))


def interlevel_loss(prop_hists: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Sum over proposal levels of mean(clip(w - w_outer, 0)^2 / (w + eps)).
    The final edges t and weights w are detached: only the proposals move."""
    t = t.detach()
    w = w.detach()
    total = 0.0
    for t_env, w_env in prop_hists:
        w_outer = outer_weights(t_env, w_env, t)
        excess = torch.clamp(w - w_outer, min=0.0)
        total = total + torch.mean(excess * excess / (w + 1e-7))
    return total


def distortion_loss(t: torch.Tensor, w: torch.Tensor, near: float, far: float) -> torch.Tensor:
    """The mip-NeRF 360 distortion loss over edges normalized to [0, 1]."""
    s = (t - near) / (far - near)
    mids = 0.5 * (s[..., 1:] + s[..., :-1])
    dm = torch.abs(mids[..., :, None] - mids[..., None, :])
    inter = torch.sum(w[..., :, None] * w[..., None, :] * dm, dim=(-2, -1))
    intra = torch.sum(w * w * (s[..., 1:] - s[..., :-1]), dim=-1) / 3.0
    return torch.mean(inter + intra)

# --- from gaussiangrasper_torch/core/rays.py (pinhole rays) ---


def generate_rays(camera: Camera, coords: torch.Tensor) -> RayBundle:
    """Rays through the centres of pixels `coords` (..., 2) integer (row,
    col). OpenGL convention: the camera looks down -z, y up."""
    c2w = camera.camera_to_world
    dev = c2w.device
    coords = torch.as_tensor(coords, device=dev)
    y = coords[..., 0].to(c2w.dtype) + 0.5
    x = coords[..., 1].to(c2w.dtype) + 0.5
    r = c2w[:3, :3]
    origin = c2w[:3, 3]
    pixel_area = 1.0 / (camera.fx * camera.fy)
    dx = (x - camera.cx) / camera.fx
    dy = -(y - camera.cy) / camera.fy
    dirs_cam = torch.stack([dx, dy, -torch.ones_like(dx)], dim=-1)
    dirs = dirs_cam @ r.T
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return RayBundle(origins=origin.expand(dirs.shape), directions=dirs,
                     pixel_area=pixel_area.expand(dirs[..., :1].shape))


# --- from gaussiangrasper_torch/models/nerf.py (the nerfacto field) ---


@dataclasses.dataclass(frozen=True)
class NerfConfig:
    field: str = "nerfacto"
    near: float = 0.05
    far: float = 6.0
    num_coarse: int = 64
    num_fine: int = 64                 # samples of the field's own pass
    hash_levels: int = 12
    hash_features: int = 2
    log2_hashmap_size: int = 17
    scene_scale: float = 2.0           # positions mapped to [0,1] by /(2*scale)+0.5
    num_appearance_embeds: int = 0     # per-image appearance embeddings
    appearance_embed_dim: int = 16
    use_proposal: bool = True
    num_proposal_samples: Tuple[int, ...] = (128, 64)
    proposal_hash_levels: int = 5
    proposal_log2_hashmap_size: int = 15


class ProposalField(nn.Module):
    """A density-only proposal field: a small hash grid and a linear head."""

    def __init__(self, cfg: NerfConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.grid = HashGrid(num_levels=cfg.proposal_hash_levels, features_per_level=2,
                             log2_hashmap_size=cfg.proposal_log2_hashmap_size, max_res=256,
                             generator=generator)
        self.density_mlp = MLP(cfg.proposal_hash_levels * 2, 1, (16,), generator)


class NerfField(nn.Module):
    """The parameters of the nerfacto field and its proposal fields."""

    def __init__(self, cfg: NerfConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        g = generator
        app = cfg.appearance_embed_dim if cfg.num_appearance_embeds else 0
        self.grid = HashGrid(num_levels=cfg.hash_levels, features_per_level=cfg.hash_features,
                             log2_hashmap_size=cfg.log2_hashmap_size, generator=g)
        # density head: 1 density + 15 geo features
        self.density_mlp = MLP(cfg.hash_levels * cfg.hash_features, 16, (64,), g)
        # colour head: SH degree-3 directions without DC (15) + geo (15)
        # + the view's appearance embedding
        self.color_mlp = MLP(15 + 15 + app, 3, (64,), g)
        if cfg.num_appearance_embeds:
            self.appearance = nn.Parameter(0.1 * torch.randn(
                (cfg.num_appearance_embeds, cfg.appearance_embed_dim), generator=g))
        for i in range(len(cfg.num_proposal_samples)):
            setattr(self, f"proposal_{i}", ProposalField(cfg, g))


def _x01(cfg: NerfConfig, positions: torch.Tensor) -> torch.Tensor:
    return torch.clamp(positions / (2 * cfg.scene_scale) + 0.5, 0.0, 1.0)


def _with_appearance(inputs, appearance, geo):
    if appearance is not None:
        inputs.append(appearance.expand(*geo.shape[:-1], appearance.shape[-1]))
    return torch.cat(inputs, dim=-1)


def _field(field: NerfField, cfg: NerfConfig, positions, directions, appearance=None):
    """(density (..., 1), rgb (..., 3), geo features (..., 15))."""
    softplus = torch.nn.functional.softplus
    h = field.density_mlp(hash_grid_encode(field.grid, _x01(cfg, positions)))
    density = softplus(h[..., :1] - 1.0)
    geo = h[..., 1:]
    d_enc = sh_encoding(directions, degree=3)[..., 1:]  # without DC: 15 dims
    rgb = torch.sigmoid(field.color_mlp(_with_appearance([d_enc, geo], appearance, geo)))
    return density, rgb, geo


def _appearance_vec(field: NerfField, cfg: NerfConfig, appearance_idx):
    if cfg.num_appearance_embeds and hasattr(field, "appearance"):
        return field.appearance[0 if appearance_idx is None else appearance_idx]
    return None


def _proposal_density(level: ProposalField, cfg: NerfConfig, positions) -> torch.Tensor:
    enc = hash_grid_encode(level.grid, _x01(cfg, positions))
    return torch.nn.functional.softplus(level.density_mlp(enc) - 1.0)


def _points(bundle: RayBundle, ts: torch.Tensor) -> torch.Tensor:
    return bundle.origins[..., None, :] + bundle.directions[..., None, :] * ts[..., None]


def _outputs(w, rgb, depth_ts, rgb_coarse) -> Dict[str, torch.Tensor]:
    black = w.new_zeros(3)
    return {
        "rgb": composite(w, rgb, background=black),
        "depth": composite(w, depth_ts),
        "accumulation": torch.sum(w, dim=-2),
        "rgb_coarse": rgb_coarse if rgb_coarse is not None
        else composite(w, rgb, background=black),
    }


def render_rays(field: NerfField, bundle: RayBundle, rng: Draws, cfg: NerfConfig,
                appearance_idx=None):
    """Density-only proposal fields refine the sample distribution before
    the main field runs once; emits the interlevel and distortion losses,
    and the proposal levels' weights ("proposal_weights")."""
    app = _appearance_vec(field, cfg, appearance_idx)
    shape = tuple(bundle.origins.shape[:-1])
    dev, dt = bundle.origins.device, bundle.origins.dtype
    span = cfg.far - cfg.near

    def edges_to_weights(level, edges):
        mids = 0.5 * (edges[..., 1:] + edges[..., :-1])
        pos = _points(bundle, mids)
        deltas = (edges[..., 1:] - edges[..., :-1])[..., None]
        return render_weights(_proposal_density(level, cfg, pos), deltas)[..., 0]

    # stratified initial edges
    n0 = cfg.num_proposal_samples[0]
    t = torch.linspace(0.0, 1.0, n0 + 1, device=dev, dtype=dt)
    edges = (cfg.near + span * t).expand(shape + (n0 + 1,))
    jitter = (uniform(rng, "edge_jitter", shape + (n0 - 1,), dev, dt) - 0.5) / n0
    interior = edges[..., 1:-1] + jitter * span
    edges = torch.cat([edges[..., :1], interior, edges[..., -1:]], dim=-1)

    hists = []
    counts = list(cfg.num_proposal_samples[1:]) + [cfg.num_fine]
    for i, n_next in enumerate(counts):
        w = edges_to_weights(getattr(field, f"proposal_{i}"), edges)
        hists.append((edges, w))
        t_next = sample_pdf(edges, w, n_next + 1, rng, name=f"pdf_u_{i}")
        edges = torch.sort(t_next, dim=-1).values

    # the main field on the final intervals
    mids = 0.5 * (edges[..., 1:] + edges[..., :-1])
    pos = _points(bundle, mids)
    dirs = bundle.directions[..., None, :].expand(pos.shape)
    dens, rgb, geo = _field(field, cfg, pos, dirs, app)
    w = render_weights(dens, (edges[..., 1:] - edges[..., :-1])[..., None])
    out = _outputs(w, rgb, mids[..., None], None)
    out["interlevel"] = interlevel_loss(hists, edges, w[..., 0])[None]
    out["distortion"] = distortion_loss(edges, w[..., 0], cfg.near, cfg.far)[None]
    out["proposal_weights"] = [pw for _, pw in hists]
    return out


# --- from gaussiangrasper_torch/engine/optimizers.py ---


def tree_map(fn, *trees):
    """`fn` over a tensor, or over the values of dicts with one key set."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _adam(g, mu, nu, count, eps: float):
    """optax.scale_by_adam on one group: (update, mu, nu, count)."""
    mu = tree_map(lambda g_, m: (1.0 - B1) * g_ + B1 * m, g, mu)
    nu = tree_map(lambda g_, v: (1.0 - B2) * (g_ * g_) + B2 * v, g, nu)
    count = count + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(B1, dtype=torch.float32, device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.tensor(B2, dtype=torch.float32, device=c.device), c)
    upd = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps), mu, nu)
    return upd, mu, nu, count


# --- from gaussiangrasper_torch/engine/nerf_trainer.py (the nerfacto terms) ---


def nerf_loss(out: Dict[str, torch.Tensor], target, target_depth, weights: Dict[str, float]):
    """(total loss, rgb mse): the step's terms, in its order."""
    mse = torch.mean((out["rgb"] - target) ** 2)
    loss = mse + weights["coarse"] * torch.mean((out["rgb_coarse"] - target) ** 2)
    dmask = (target_depth > 0.05).to(mse.dtype)
    dl1 = torch.sum(torch.abs(out["depth"][..., 0] - target_depth) * dmask) \
        / torch.clamp(torch.sum(dmask), min=1.0)
    loss = loss + weights["depth"] * dl1
    loss = loss + weights["interlevel"] * torch.mean(out["interlevel"])
    loss = loss + weights["distortion"] * torch.mean(out["distortion"])
    return loss, mse


def nerf_step(field: NerfField, opt: Dict, camera: Camera, coords: torch.Tensor,
              target: torch.Tensor, target_depth: torch.Tensor, rng: Draws,
              cfg: NerfConfig, lr: float, weights: Dict[str, float],
              app_idx=None) -> Dict[str, Any]:
    """One step: render, loss, gradients, Adam (in place on `field` and
    `opt`). Returns the metrics loss (the rgb mse) and psnr, and, for the
    check, render_rays' outputs detached ("render")."""
    params = dict(field.named_parameters())
    out = render_rays(field, generate_rays(camera, coords), rng, cfg, appearance_idx=app_idx)
    loss, mse = nerf_loss(out, target, target_depth, weights)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    with torch.no_grad():
        g = {n: torch.zeros_like(p) if gr is None else gr
             for (n, p), gr in zip(params.items(), grads)}
        upd, opt["mu"], opt["nu"], opt["count"] = _adam(g, opt["mu"], opt["nu"],
                                                        opt["count"], ADAM_EPS)
        for n, p in params.items():
            p.add_(upd[n] * (-lr))  # optax: scale by -lr, then add
        mse = mse.detach()
    render = {k: ([x.detach() for x in v] if isinstance(v, list) else v.detach())
              for k, v in out.items()}
    return {"loss": mse, "psnr": -10.0 * torch.log10(torch.clamp(mse, min=1e-12)),
            "render": render}


# --- from gaussiangrasper_torch/data/pixel_samplers.py ---

@dataclasses.dataclass
class PixelSampler:
    """Uniform sampler (ref pixel_samplers.py:53): R iid pixels."""

    rays_per_batch: int = 1024

    def sample(self, rng: np.random.Generator, height: int,
               width: int) -> np.ndarray:
        ys = rng.integers(0, height, self.rays_per_batch)
        xs = rng.integers(0, width, self.rays_per_batch)
        return np.stack([ys, xs], axis=-1).astype(np.int32)

