"""Ray-marched radiance-field models, the NeRF-family zoo (counterpart of
the JAX package's models/nerf.py). One render interface over seven fields:

  - "vanilla":     positional-encoded MLP, hierarchical sampling
  - "nerfacto":    multiresolution hash grid + small MLPs
  - "mipnerf":     integrated positional encoding over conical frustums
                   (models/mip.py)
  - "instant-ngp": hash grid + occupancy-grid masking (models/occupancy.py)
  - "tensorf":     VM-decomposed factor grids (models/tensorf_field.py)
  - "neus" / "neus-facto": SDF + logistic-CDF alphas (models/sdf_field.py)

and three variants: num_semantic_classes > 0 adds a semantic head over the
geometry features, composited with detached weights; num_appearance_embeds
> 0 adds per-image appearance embeddings to the colour head; deformation
adds a time-conditioned warp MLP (zeroed last layer: the identity at init).

`NerfField` is an `nn.Module` whose parameter names are the JAX params
pytree's keys joined by dots (`grid.table`, `density_mlp.w0`,
`proposal_0.grid.table`, `deform_mlp.w2`, `s`, ...), so the JAX package's
arrays load by name (`engine/weights.nerf_params_from_numpy`). The hash
grids' `resolutions` are buffers.

`render_rays` draws its randomness from `rng`: a `torch.Generator`, or a
mapping from the names in `draw_shapes` to uniform tensors (core/rays.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from gaussiangrasper_torch.core.rays import (
    Draws,
    RayBundle,
    composite,
    render_weights,
    sample_along_rays,
    sample_pdf,
    uniform,
)
from gaussiangrasper_torch.models import mip, occupancy, proposal, sdf_field, tensorf_field
from gaussiangrasper_torch.models.efd import MLP
from gaussiangrasper_torch.models.encodings import (
    HashGrid,
    hash_grid_encode,
    positional_encoding,
    sh_encoding,
)

@dataclasses.dataclass(frozen=True)
class NerfConfig:
    field: str = "nerfacto"  # vanilla|nerfacto|mipnerf|instant-ngp|tensorf|neus|neus-facto
    near: float = 0.05
    far: float = 6.0
    num_coarse: int = 64
    num_fine: int = 64                 # pdf-resampled / second pass
    pos_freqs: int = 10
    dir_freqs: int = 4
    hidden: int = 128
    hash_levels: int = 12
    hash_features: int = 2
    log2_hashmap_size: int = 17
    scene_scale: float = 2.0           # positions mapped to [0,1] by /(2*scale)+0.5
    # tensorf
    tensorf_resolution: int = 128
    tensorf_density_components: int = 8
    tensorf_appearance_components: int = 24
    # variants
    num_semantic_classes: int = 0      # semantic-nerfw head
    num_appearance_embeds: int = 0     # phototourism per-image embeddings
    appearance_embed_dim: int = 16
    deformation: bool = False          # dnerf time-warp
    time_freqs: int = 4
    deform_freqs: int = 6
    # proposal-network sampling: density-only proposal fields + pdf refinement
    use_proposal: bool = False
    num_proposal_samples: Tuple[int, ...] = (128, 64)
    proposal_hash_levels: int = 5
    proposal_log2_hashmap_size: int = 15


def _geo_dim(cfg: NerfConfig) -> int:
    """Width of the geometry features each field hands to extra heads."""
    if cfg.field in ("vanilla", "mipnerf"):
        return cfg.hidden
    if cfg.field in ("nerfacto", "instant-ngp"):
        return 15
    return 0  # tensorf / sdf fields expose no shared geo features


class ProposalField(nn.Module):
    """A density-only proposal field: a small hash grid and a linear head."""

    def __init__(self, cfg: NerfConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.grid = HashGrid(num_levels=cfg.proposal_hash_levels, features_per_level=2,
                             log2_hashmap_size=cfg.proposal_log2_hashmap_size, max_res=256,
                             generator=generator)
        self.density_mlp = MLP(cfg.proposal_hash_levels * 2, 1, (16,), generator)


class NerfField(nn.Module):
    """The parameters of one configured field and its variants."""

    def __init__(self, cfg: NerfConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        g = generator
        app = cfg.appearance_embed_dim if cfg.num_appearance_embeds else 0
        if cfg.field in ("vanilla", "mipnerf"):
            # mipnerf: one MLP for the coarse and fine passes, over IPE
            # features (no raw-input term)
            in_dim = 6 * cfg.pos_freqs + (3 if cfg.field == "vanilla" else 0)
            dir_dim = 3 + 6 * cfg.dir_freqs
            self.density_mlp = MLP(in_dim, cfg.hidden + 1, (cfg.hidden,) * 3, g)
            self.color_mlp = MLP(cfg.hidden + dir_dim + app, 3, (cfg.hidden // 2,), g)
        elif cfg.field in ("nerfacto", "instant-ngp"):
            self.grid = HashGrid(num_levels=cfg.hash_levels, features_per_level=cfg.hash_features,
                                 log2_hashmap_size=cfg.log2_hashmap_size, generator=g)
            # density head: 1 density + 15 geo features
            self.density_mlp = MLP(cfg.hash_levels * cfg.hash_features, 16, (64,), g)
            # colour head: SH degree-3 directions without DC (15) + geo (15)
            self.color_mlp = MLP(15 + 15 + app, 3, (64,), g)
        elif cfg.field == "tensorf":
            self._add(tensorf_field.init_tensorf(
                resolution=cfg.tensorf_resolution,
                density_components=cfg.tensorf_density_components,
                appearance_components=cfg.tensorf_appearance_components, generator=g))
        elif cfg.field in ("neus", "neus-facto"):
            self._add(sdf_field.init_sdf_field(variant=cfg.field, generator=g))
        else:
            raise ValueError(f"unknown field {cfg.field!r}")

        if cfg.num_semantic_classes:
            if _geo_dim(cfg) == 0:
                raise ValueError(
                    f"field {cfg.field!r} exposes no geometry features; the semantic head "
                    "(semantic-nerfw) needs a vanilla/mipnerf/nerfacto/instant-ngp field")
            self.semantic_mlp = MLP(_geo_dim(cfg), cfg.num_semantic_classes, (64,), g)
        if cfg.num_appearance_embeds:
            self.appearance = nn.Parameter(0.1 * torch.randn(
                (cfg.num_appearance_embeds, cfg.appearance_embed_dim), generator=g))
        if cfg.use_proposal:
            for i in range(len(cfg.num_proposal_samples)):
                setattr(self, f"proposal_{i}", ProposalField(cfg, g))
        if cfg.deformation:
            in_dim = (3 + 6 * cfg.deform_freqs) + (1 + 2 * cfg.time_freqs)
            dmlp = MLP(in_dim, 3, (64, 64), g)
            last = dmlp.num_layers - 1
            with torch.no_grad():  # the identity warp at init
                getattr(dmlp, f"w{last}").zero_()
                getattr(dmlp, f"b{last}").zero_()
            self.deform_mlp = dmlp

    def _add(self, params: Dict[str, nn.Module]) -> None:
        for name, p in params.items():
            setattr(self, name, p)


def init_nerf(cfg: NerfConfig, seed: int = 0, device=None) -> NerfField:
    """A field drawn on the CPU from a generator seeded with `seed`, then
    moved to `device`: the same values on every device."""
    return NerfField(cfg, torch.Generator().manual_seed(seed)).to(device)


def _x01(cfg: NerfConfig, positions: torch.Tensor) -> torch.Tensor:
    return torch.clamp(positions / (2 * cfg.scene_scale) + 0.5, 0.0, 1.0)


def _deform(field: NerfField, cfg: NerfConfig, positions, times):
    """dnerf temporal warp: x_canonical = x + MLP(PE(x), PE(t))."""
    if not cfg.deformation or not hasattr(field, "deform_mlp"):
        return positions
    t = torch.as_tensor(times, dtype=positions.dtype, device=positions.device)
    t = t.expand(positions.shape[:-1])
    t_enc = positional_encoding(t[..., None], cfg.time_freqs)
    x_enc = positional_encoding(positions, cfg.deform_freqs)
    return positions + field.deform_mlp(torch.cat([x_enc, t_enc], dim=-1))


def _with_appearance(inputs, appearance, geo):
    if appearance is not None:
        inputs.append(appearance.expand(*geo.shape[:-1], appearance.shape[-1]))
    return torch.cat(inputs, dim=-1)


def _field(field: NerfField, cfg: NerfConfig, positions, directions, appearance=None,
           ipe_cov=None):
    """(density (..., 1), rgb (..., 3), geo features (..., G))."""
    if cfg.field == "tensorf":
        x01 = _x01(cfg, positions)
        density = tensorf_field.tensorf_density(field, x01)
        rgb = tensorf_field.tensorf_rgb(field, x01, directions)
        return density, rgb, positions.new_zeros(positions.shape[:-1] + (0,))
    softplus = torch.nn.functional.softplus
    if cfg.field in ("nerfacto", "instant-ngp"):
        h = field.density_mlp(hash_grid_encode(field.grid, _x01(cfg, positions)))
        density = softplus(h[..., :1] - 1.0)
        geo = h[..., 1:]
        d_enc = sh_encoding(directions, degree=3)[..., 1:]  # without DC: 15 dims
        rgb = torch.sigmoid(field.color_mlp(_with_appearance([d_enc, geo], appearance, geo)))
        return density, rgb, geo
    # vanilla / mipnerf MLP fields
    if cfg.field == "mipnerf":
        enc = mip.integrated_pos_enc(positions, ipe_cov, cfg.pos_freqs)
    else:
        enc = positional_encoding(positions, cfg.pos_freqs)
    h = field.density_mlp(enc)
    density = softplus(h[..., :1] - 1.0)
    geo = h[..., 1:]
    d_enc = positional_encoding(directions, cfg.dir_freqs)
    rgb = torch.sigmoid(field.color_mlp(_with_appearance([geo, d_enc], appearance, geo)))
    return density, rgb, geo


def _semantics(field: NerfField, cfg: NerfConfig, geo, weights):
    """Semantic logits composited with gradient-detached weights."""
    if not cfg.num_semantic_classes or not hasattr(field, "semantic_mlp"):
        return None
    return torch.sum(weights.detach() * field.semantic_mlp(geo), dim=-2)


def _appearance_vec(field: NerfField, cfg: NerfConfig, appearance_idx):
    if cfg.num_appearance_embeds and hasattr(field, "appearance"):
        return field.appearance[0 if appearance_idx is None else appearance_idx]
    return None


def draw_shapes(cfg: NerfConfig, num_rays: int) -> Dict[str, Tuple[int, ...]]:
    """The uniform draws `render_rays` takes for `num_rays` rays, by name."""
    r = (num_rays,)
    if cfg.field == "mipnerf":
        return {"edge_jitter": r + (cfg.num_coarse - 1,), "pdf_u": r + (cfg.num_fine + 1,)}
    if cfg.field in ("neus", "neus-facto", "instant-ngp"):
        return {"jitter": r + (cfg.num_coarse + cfg.num_fine,)}
    if cfg.use_proposal:
        shapes = {"edge_jitter": r + (cfg.num_proposal_samples[0] - 1,)}
        counts = list(cfg.num_proposal_samples[1:]) + [cfg.num_fine]
        for i, n_next in enumerate(counts):
            shapes[f"pdf_u_{i}"] = r + (n_next + 1,)
        return shapes
    return {"jitter": r + (cfg.num_coarse,), "pdf_u": r + (cfg.num_fine,)}


def render_rays(field: NerfField, bundle: RayBundle, rng: Draws, cfg: NerfConfig,
                grid: Optional[occupancy.OccupancyGrid] = None,
                times: Optional[torch.Tensor] = None,
                appearance_idx: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Render a ray bundle under the configured field. Optional inputs:
    `grid` (instant-ngp occupancy), `times` (dnerf), `appearance_idx`
    (phototourism per-image embedding row)."""
    if cfg.field == "mipnerf":
        return _render_mipnerf(field, bundle, rng, cfg, appearance_idx)
    if cfg.field in ("neus", "neus-facto"):
        return _render_neus(field, bundle, rng, cfg)
    if cfg.field == "instant-ngp":
        return _render_ingp(field, bundle, rng, cfg, grid, appearance_idx)
    if cfg.use_proposal:
        return _render_proposal(field, bundle, rng, cfg, times, appearance_idx)
    return _render_hierarchical(field, bundle, rng, cfg, times, appearance_idx)


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


def _render_proposal(field, bundle, rng, cfg, times, appearance_idx):
    """Density-only proposal fields refine the sample distribution before
    the main field runs once; emits the interlevel and distortion losses."""
    app = _appearance_vec(field, cfg, appearance_idx)
    shape = tuple(bundle.origins.shape[:-1])
    dev, dt = bundle.origins.device, bundle.origins.dtype
    span = cfg.far - cfg.near

    def edges_to_weights(level, edges):
        mids = 0.5 * (edges[..., 1:] + edges[..., :-1])
        pos = _points(bundle, mids)
        if cfg.deformation:
            pos = _deform(field, cfg, pos, times)
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
    if cfg.deformation:
        pos = _deform(field, cfg, pos, times)
    dirs = bundle.directions[..., None, :].expand(pos.shape)
    dens, rgb, geo = _field(field, cfg, pos, dirs, app)
    w = render_weights(dens, (edges[..., 1:] - edges[..., :-1])[..., None])
    out = _outputs(w, rgb, mids[..., None], None)
    out["interlevel"] = proposal.interlevel_loss(hists, edges, w[..., 0])[None]
    out["distortion"] = proposal.distortion_loss(edges, w[..., 0], cfg.near, cfg.far)[None]
    sem = _semantics(field, cfg, geo, w)
    if sem is not None:
        out["semantics"] = sem
    return out


def _render_hierarchical(field, bundle, rng, cfg, times, appearance_idx):
    """A uniform coarse pass, then an inverse-CDF fine pass over the coarse
    midpoints and the fine samples together (last delta 1e10)."""
    app = _appearance_vec(field, cfg, appearance_idx)
    coarse = sample_along_rays(bundle, cfg.near, cfg.far, cfg.num_coarse, rng)
    pos_c = _deform(field, cfg, coarse.positions, times) if cfg.deformation else coarse.positions
    dens_c, rgb_c, _ = _field(field, cfg, pos_c, coarse.directions, app)
    w_c = render_weights(dens_c, coarse.deltas)

    # fine resampling around the coarse weights
    mids = 0.5 * (coarse.starts[..., 0] + coarse.ends[..., 0])
    edges = torch.cat([coarse.starts[..., :1, 0], 0.5 * (mids[..., 1:] + mids[..., :-1]),
                       coarse.ends[..., -1:, 0]], dim=-1)
    t_fine = sample_pdf(edges, w_c[..., 0], cfg.num_fine, rng)
    t_all = torch.sort(torch.cat([mids, t_fine], dim=-1), dim=-1).values
    pos = _points(bundle, t_all)
    if cfg.deformation:
        pos = _deform(field, cfg, pos, times)
    dirs = bundle.directions[..., None, :].expand(pos.shape)
    dens, rgb, geo = _field(field, cfg, pos, dirs, app)
    deltas = torch.cat([t_all[..., 1:] - t_all[..., :-1],
                        torch.full_like(t_all[..., :1], 1e10)], dim=-1)[..., None]
    w = render_weights(dens, deltas)
    out = _outputs(w, rgb, t_all[..., None],
                   composite(w_c, rgb_c, background=w.new_zeros(3)))
    sem = _semantics(field, cfg, geo, w)
    if sem is not None:
        out["semantics"] = sem
    return out


def _render_mipnerf(field, bundle, rng, cfg, appearance_idx):
    """Two-level cone rendering with one shared MLP."""
    app = _appearance_vec(field, cfg, appearance_idx)
    radius = mip.pixel_radius(bundle.pixel_area)
    shape = tuple(bundle.origins.shape[:-1])
    dev, dt = bundle.origins.device, bundle.origins.dtype

    # stratified coarse edges: interior boundaries jittered, near/far fixed
    t = torch.linspace(0.0, 1.0, cfg.num_coarse + 1, device=dev, dtype=dt)
    edges = (cfg.near + (cfg.far - cfg.near) * t).expand(shape + (cfg.num_coarse + 1,))
    jitter = uniform(rng, "edge_jitter", shape + (cfg.num_coarse - 1,), dev, dt) - 0.5
    widths = torch.diff(edges, dim=-1)
    interior = edges[..., 1:-1] + jitter * torch.minimum(widths[..., :-1], widths[..., 1:])
    edges = torch.cat([edges[..., :1], interior, edges[..., -1:]], dim=-1)

    def level(level_edges):
        starts, ends = level_edges[..., :-1], level_edges[..., 1:]
        means, cov = mip.conical_frustum_to_gaussian(bundle.origins, bundle.directions,
                                                      starts, ends, radius)
        dirs = bundle.directions[..., None, :].expand(means.shape)
        dens, rgb, _ = _field(field, cfg, means, dirs, app, ipe_cov=cov)
        return render_weights(dens, (ends - starts)[..., None]), rgb, 0.5 * (starts + ends)

    w_c, rgb_c, _ = level(edges)
    t_fine = sample_pdf(edges, w_c[..., 0], cfg.num_fine + 1, rng)
    w, rgb, mids = level(torch.sort(t_fine, dim=-1).values)
    return _outputs(w, rgb, mids[..., None],
                    composite(w_c, rgb_c, background=w.new_zeros(3)))


def _render_ingp(field, bundle, rng, cfg, grid, appearance_idx):
    """One dense pass with occupancy masking."""
    app = _appearance_vec(field, cfg, appearance_idx)
    n = cfg.num_coarse + cfg.num_fine
    samples = sample_along_rays(bundle, cfg.near, cfg.far, n, rng)
    dens, rgb, geo = _field(field, cfg, samples.positions, samples.directions, app)
    num_live = torch.tensor(samples.positions.shape[0] * samples.positions.shape[1],
                            dtype=torch.int32, device=dens.device)
    if grid is not None:
        dens = occupancy.masked_densities(grid, samples.positions, dens)
        # live samples (in occupied cells), for the dynamic batch sizer
        num_live = torch.sum(occupancy.occupancy_mask(grid, samples.positions),
                             dtype=torch.int32)
    w = render_weights(dens, samples.deltas)
    out = _outputs(w, rgb, 0.5 * (samples.starts + samples.ends), None)
    out["num_live_samples"] = num_live
    sem = _semantics(field, cfg, geo, w)
    if sem is not None:
        out["semantics"] = sem
    return out


def _render_neus(field, bundle, rng, cfg):
    """SDF rendering with the NeuS alpha estimator; emits normals and the
    eikonal residual."""
    n = cfg.num_coarse + cfg.num_fine
    samples = sample_along_rays(bundle, cfg.near, cfg.far, n, rng)
    sdf, geo = sdf_field.sdf_and_features(field, samples.positions, cfg.scene_scale)
    grad = sdf_field.sdf_gradient(field, samples.positions, cfg.scene_scale)
    inv_std = torch.exp(10.0 * field.s)
    alphas = sdf_field.neus_alphas(sdf, grad, samples.directions, samples.deltas, inv_std)
    w = sdf_field.alphas_to_weights(alphas)
    gnorm = torch.linalg.norm(grad, dim=-1, keepdim=True)
    normals = grad / torch.clamp(gnorm, min=1e-6)
    rgb = sdf_field.sdf_rgb(field, samples.positions, samples.directions, normals, geo)
    out = _outputs(w, rgb, 0.5 * (samples.starts + samples.ends), None)
    out["normal"] = composite(w, normals)
    out["eikonal"] = torch.mean((gnorm[..., 0] - 1.0) ** 2, dim=-1, keepdim=True)
    return out
