"""Text-to-3D (generfacto): random orbit cameras and the Score Distillation
Sampling loss (counterpart of the JAX package's models/generative.py).

The denoiser is a pluggable `Guidance`. `ColorTargetGuidance` is a
closed-form stand-in whose "denoiser" pushes the latents toward a constant
colour, so SDS converges the field to that colour iff the SDS plumbing is
right. `StableDiffusionGuidance` needs locally cached diffusion weights,
which are not in the repository: it raises, as the JAX package's does.

Draws are explicit (core/rays.py): `random_orbit_camera` takes "vertical",
"central", "focal" (uniform scalars), "radius" and "jitter" (normal (3,));
`sds_loss` takes "t" (a uniform scalar) and "eps" (normals of the latents'
shape), and hands `rng` on to `predict_noise`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from gaussiangrasper_torch._device import full_f32
from gaussiangrasper_torch.core.cameras import Camera
from gaussiangrasper_torch.core.rays import Draws, generate_rays, normal, uniform


def random_orbit_camera(
    rng: Draws,
    resolution: int = 64,
    radius_mean: float = 1.0,
    radius_std: float = 0.1,
    central_rotation_range: Tuple[float, float] = (0.0, 360.0),
    vertical_rotation_range: Tuple[float, float] = (-90.0, 0.0),
    focal_range: Tuple[float, float] = (0.75, 1.35),
    jitter_std: float = 0.01,
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    device=None,
) -> Tuple[Camera, torch.Tensor, torch.Tensor]:
    """One random orbit pose: the vertical rotation uniform on the sphere
    (arccos of a uniform), the central rotation uniform in its range, the
    camera at radius * R @ [0, 0, 1] + jitter looking at the centre.
    Returns (camera, vertical_deg, central_deg)."""
    vlo, vhi = vertical_rotation_range[0] + 90.0, vertical_rotation_range[1] + 90.0
    u = (uniform(rng, "vertical", (), device) * (vhi - vlo) + vlo) / 180.0
    vertical = torch.arccos(1.0 - 2.0 * u)
    central = torch.deg2rad(uniform(rng, "central", (), device)
                            * (central_rotation_range[1] - central_rotation_range[0])
                            + central_rotation_range[0])
    c_cos, c_sin = torch.cos(central), torch.sin(central)
    v_cos, v_sin = torch.cos(vertical), torch.sin(vertical)
    zero, one = torch.zeros_like(c_cos), torch.ones_like(c_cos)
    rot_z = torch.stack([torch.stack([c_cos, -c_sin, zero]), torch.stack([c_sin, c_cos, zero]),
                         torch.stack([zero, zero, one])])
    rot_x = torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, v_cos, -v_sin]),
                         torch.stack([zero, v_sin, v_cos])])
    r = rot_z @ rot_x
    origin = torch.tensor([0.0, 0.0, 1.0], device=device) * (
        radius_mean + normal(rng, "radius", (3,), device) * radius_std)
    t = (r @ origin + normal(rng, "jitter", (3,), device) * jitter_std
         + torch.tensor(center, dtype=torch.float32, device=device))
    c2w = torch.cat([r, t[:, None]], dim=-1)
    focal = (uniform(rng, "focal", (), device) * (focal_range[1] - focal_range[0])
             + focal_range[0]) * resolution
    cam = Camera.create(fx=focal, fy=focal, cx=resolution / 2, cy=resolution / 2,
                        camera_to_world=c2w, width=resolution, height=resolution, device=device)
    return cam, torch.rad2deg(vertical), torch.rad2deg(central)


class Guidance:
    """Denoiser interface for SDS:
      encode(rgb (H, W, 3)) -> latents
      predict_noise(rng, noisy_latents, noise level t in [0, 1], embed)
          -> predicted noise (guidance-scaled)
    """

    def encode(self, rgb: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def predict_noise(self, rng: Draws, latents_noisy, t, embed) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass
class ColorTargetGuidance(Guidance):
    """Analytic stand-in: latents = pixels, and the 'denoiser' predicts the
    residual toward a constant target colour, so the SDS gradient
    w * (eps_pred - eps) points from the render toward the target."""

    target_color: Tuple[float, float, float] = (1.0, 0.3, 0.1)

    def encode(self, rgb):
        return rgb

    def predict_noise(self, rng, latents_noisy, t, embed):
        del rng, t, embed
        return latents_noisy - torch.tensor(self.target_color, dtype=latents_noisy.dtype,
                                            device=latents_noisy.device)


class StableDiffusionGuidance(Guidance):
    """Latent-diffusion guidance. Needs locally cached diffusers weights,
    which the repository does not hold: construction raises."""

    def __init__(self, model_dir: Optional[str] = None):
        import os

        if model_dir is None or not os.path.isdir(model_dir):
            raise SystemExit(
                "StableDiffusionGuidance needs locally cached diffusion "
                "weights (pass model_dir=<path to a diffusers checkout>); use "
                "ColorTargetGuidance for scaffold testing."
            )
        raise NotImplementedError("wire a PyTorch UNet from the local checkout here")


def sds_loss(guidance: Guidance, rng: Draws, rgb: torch.Tensor,
             embed: Optional[torch.Tensor] = None,
             t_range: Tuple[float, float] = (0.02, 0.98)) -> torch.Tensor:
    """Score Distillation Sampling: 0.5 ||latents - sg(latents - grad)||^2
    with grad = w(t) (eps_pred - eps), whose gradient with respect to the
    latents is exactly `grad`."""
    latents = guidance.encode(rgb)
    dev = latents.device
    t = uniform(rng, "t", (), dev) * (t_range[1] - t_range[0]) + t_range[0]
    eps = normal(rng, "eps", tuple(latents.shape), dev)
    noisy = torch.sqrt(1.0 - t) * latents + torch.sqrt(t) * eps
    eps_pred = guidance.predict_noise(rng, noisy, t, embed).detach()
    w = t  # w(t) = 1 - alpha_t, with alpha = 1 - t in this parametrization
    grad = torch.nan_to_num(w * (eps_pred - eps))
    target = (latents - grad).detach()
    return 0.5 * torch.sum((latents - target) ** 2) / latents.shape[0]


def opacity_loss(accumulation: torch.Tensor, mult: float = 1e-3) -> torch.Tensor:
    """Sparsity prior on the accumulated alpha."""
    return mult * torch.sqrt(torch.mean(accumulation) ** 2 + 0.01)


@dataclasses.dataclass
class GenerfactoConfig:
    resolution: int = 64
    max_iterations: int = 200
    lr: float = 1e-2
    radius_mean: float = 1.8
    guidance_scale: float = 1.0
    opacity_mult: float = 1e-3


def train_generfacto(generator: torch.Generator, guidance: Guidance, cfg: GenerfactoConfig,
                     embed: Optional[torch.Tensor] = None, nerf_cfg=None,
                     progress: Optional[Callable[[int, float], None]] = None, seed: int = 0,
                     device=None):
    """The generfacto loop: every step renders the field (a `seed`-drawn
    vanilla field unless `nerf_cfg` says otherwise) from a fresh random
    orbit camera and descends the SDS + opacity losses with Adam (optax's
    order, eps 1e-8). Each step draws its camera, then the renderer's and
    SDS's uniforms, from `generator`. Returns the trained field and a
    render callable."""
    from gaussiangrasper_torch.engine.nerf_trainer import ADAM_EPS, init_adam
    from gaussiangrasper_torch.engine.optimizers import _adam
    from gaussiangrasper_torch.models.nerf import NerfConfig, init_nerf, render_rays

    nerf_cfg = nerf_cfg or NerfConfig(field="vanilla", num_coarse=32, num_fine=0, hidden=32,
                                      near=cfg.radius_mean - 1.0, far=cfg.radius_mean + 1.0)
    field = init_nerf(nerf_cfg, seed=seed, device=device)
    params = dict(field.named_parameters())
    opt = init_adam(field)
    for i in range(cfg.max_iterations):
        cam, _, _ = random_orbit_camera(generator, cfg.resolution, radius_mean=cfg.radius_mean,
                                        device=device)
        with full_f32():
            outs = render_rays(field, generate_rays(cam), generator, nerf_cfg)
            rgb = outs["rgb"].reshape(cfg.resolution, cfg.resolution, 3)
            loss = (sds_loss(guidance, generator, rgb, embed) * cfg.guidance_scale
                    + opacity_loss(outs["accumulation"], cfg.opacity_mult))
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        with torch.no_grad():
            g = {n: torch.zeros_like(p) if gr is None else gr
                 for (n, p), gr in zip(params.items(), grads)}
            upd, opt["mu"], opt["nu"], opt["count"] = _adam(g, opt["mu"], opt["nu"],
                                                            opt["count"], ADAM_EPS)
            for n, p in params.items():
                p.add_(upd[n] * (-cfg.lr))
        if progress is not None:
            progress(i, float(loss.detach()))

    def render_view(cam: Camera) -> torch.Tensor:
        with torch.no_grad(), full_f32():
            gen = torch.Generator(device=cam.camera_to_world.device).manual_seed(0)
            outs = render_rays(field, generate_rays(cam), gen, nerf_cfg)
        return outs["rgb"].reshape(cam.height, cam.width, 3)

    return field, render_view
