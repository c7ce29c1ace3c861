"""Trainer for the ray-marched (NeRF-family) models (counterpart of the JAX
package's engine/nerf_trainer.py).

Each step samples R pixels of a random cached view, generates their rays,
renders them and descends the loss against the ground-truth pixels with
Adam (optax's order of operations, `optimizers._adam`, eps 1e-8). The
variants' terms: masked depth L1 (depth-nerfacto), an occupancy grid
EMA-updated every `grid_update_every` steps from jittered cell centres
(instant-ngp), the eikonal term (neus), L1 on the density factors
(tensorf), cross-entropy on composited semantic logits with SAM-mask labels
(semantic-nerfw), per-view times (dnerf) and per-view appearance rows
(phototourism).

Randomness: the pixels come from a numpy Generator seeded with `seed` (the
JAX package's draws, number for number), the renderer's and the grid
update's uniforms from a torch Generator on the device, unless `draws` is
set: then `draws(kind, num_rays)` ("step" or "grid") returns the draws for
that call (core/rays.py), which is how a test replays the JAX package's
keys. Checkpoints are torch files `checkpoints/step_{:09d}.pt` that `load`
resumes from.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from gaussiangrasper_torch._device import full_f32
from gaussiangrasper_torch.core.cameras import Camera
from gaussiangrasper_torch.core.rays import Draws, generate_rays, uniform
from gaussiangrasper_torch.data.manager import FullImageDatamanager
from gaussiangrasper_torch.data.pixel_samplers import make_pixel_sampler
from gaussiangrasper_torch.engine import optimizers as optim
from gaussiangrasper_torch.engine.checkpoint import STEP_FMT
from gaussiangrasper_torch.engine.dynamic_batch import DynamicBatchSizer
from gaussiangrasper_torch.models import occupancy
from gaussiangrasper_torch.models.nerf import NerfConfig, NerfField, _field, init_nerf, render_rays
from gaussiangrasper_torch.models.tensorf_field import tensorf_l1_reg
from gaussiangrasper_torch.utils.profiler import PROFILER
from gaussiangrasper_torch.utils.writer import MetricsWriter

ADAM_EPS = 1e-8  # optax.adam's default


@dataclasses.dataclass
class NerfTrainerConfig:
    data: Path = Path("data")
    output_dir: Path = Path("outputs")
    experiment_name: str = "nerfacto"
    max_iterations: int = 5000
    rays_per_batch: int = 1024
    pixel_sampler: str = "uniform"
    """"uniform", "patch" (patch-based losses) or "pair" (pair/ranking
    losses): data/pixel_samplers.py."""
    patch_size: int = 8
    pair_radius: int = 2
    lr: float = 5e-3
    depth_lambda: float = 0.0      # depth L1 weight (depth-nerfacto)
    eikonal_lambda: float = 0.1    # neus family
    semantic_lambda: float = 0.0   # semantic-nerfw
    tensorf_reg_lambda: float = 0.0
    interlevel_lambda: float = 1.0   # nerfacto proposal losses
    distortion_lambda: float = 0.002
    coarse_rgb_lambda: float = 0.1
    use_occupancy_grid: bool = False   # instant-ngp
    grid_resolution: int = 64
    grid_update_every: int = 16
    dynamic_batch: bool = False
    """Adapt rays a batch to a constant live-sample count
    (engine/dynamic_batch.py; pairs with use_occupancy_grid)."""
    target_num_samples: int = 1 << 18
    steps_per_save: int = 2000
    steps_per_log: int = 50
    seed: int = 42
    model: NerfConfig = dataclasses.field(default_factory=NerfConfig)

    @property
    def run_dir(self) -> Path:
        return Path(self.output_dir) / self.experiment_name


def loss_weights(c: NerfTrainerConfig) -> Dict[str, float]:
    m = c.model
    return {
        "depth": c.depth_lambda,
        "eikonal": c.eikonal_lambda if m.field in ("neus", "neus-facto") else 0.0,
        "semantic": c.semantic_lambda,
        "tensorf_reg": c.tensorf_reg_lambda,
        "coarse": c.coarse_rgb_lambda,
        "interlevel": c.interlevel_lambda,
        "distortion": c.distortion_lambda,
    }


def init_adam(field: NerfField) -> Dict:
    params = dict(field.named_parameters())
    zeros = {n: torch.zeros_like(p) for n, p in params.items()}
    return {"mu": zeros, "nu": {n: torch.zeros_like(p) for n, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)}


def nerf_loss(field: NerfField, cfg: NerfConfig, out: Dict[str, torch.Tensor], target, target_depth,
              target_sem, weights: Dict[str, float]):
    """(total loss, rgb mse): every term of the JAX package's step, in its
    order."""
    mse = torch.mean((out["rgb"] - target) ** 2)
    loss = mse + weights["coarse"] * torch.mean((out["rgb_coarse"] - target) ** 2)
    dmask = (target_depth > 0.05).to(mse.dtype)
    dl1 = torch.sum(torch.abs(out["depth"][..., 0] - target_depth) * dmask) \
        / torch.clamp(torch.sum(dmask), min=1.0)
    loss = loss + weights["depth"] * dl1
    if "eikonal" in out:
        loss = loss + weights["eikonal"] * torch.mean(out["eikonal"])
    if "interlevel" in out:
        loss = loss + weights["interlevel"] * torch.mean(out["interlevel"])
        loss = loss + weights["distortion"] * torch.mean(out["distortion"])
    if "semantics" in out and cfg.num_semantic_classes:
        c = cfg.num_semantic_classes
        valid = ((target_sem >= 0) & (target_sem < c)).to(mse.dtype)
        logp = torch.log_softmax(out["semantics"], dim=-1)
        lbl = torch.clamp(target_sem, 0, c - 1).to(torch.int64)
        ce = -torch.gather(logp, -1, lbl[..., None])[..., 0]
        loss = loss + weights["semantic"] * (torch.sum(ce * valid)
                                             / torch.clamp(torch.sum(valid), min=1.0))
    if cfg.field == "tensorf":
        loss = loss + weights["tensorf_reg"] * tensorf_l1_reg(field)
    return loss, mse


def nerf_step(field: NerfField, opt: Dict, camera: Camera, coords: torch.Tensor,
              target: torch.Tensor, target_depth: torch.Tensor, target_sem: torch.Tensor,
              t_frame, app_idx, grid: Optional[occupancy.OccupancyGrid], rng: Draws,
              cfg: NerfConfig, lr: float, weights: Dict[str, float],
              step: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One step: render, loss, gradients, Adam (in place on `field` and
    `opt`). Returns the metrics loss (the rgb mse), psnr and, for
    instant-ngp, num_samples. Traced, it is the span `nerf_step` (`step`
    its argument) with children render (with the loss), backward and adam."""
    with PROFILER.section("nerf_step", step=step):
        params = dict(field.named_parameters())
        with full_f32():
            with PROFILER.section("render"):
                out = render_rays(field, generate_rays(camera, coords), rng, cfg, grid=grid,
                                  times=t_frame, appearance_idx=app_idx)
                loss, mse = nerf_loss(field, cfg, out, target, target_depth, target_sem, weights)
            with PROFILER.section("backward"):
                grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        with torch.no_grad(), PROFILER.section("adam"):
            g = {n: torch.zeros_like(p) if gr is None else gr
                 for (n, p), gr in zip(params.items(), grads)}
            upd, opt["mu"], opt["nu"], opt["count"] = optim._adam(g, opt["mu"], opt["nu"],
                                                                  opt["count"], ADAM_EPS)
            for n, p in params.items():
                p.add_(upd[n] * (-lr))  # optax: scale by -lr, then add
            mse = mse.detach()
            metrics = {"loss": mse, "psnr": -10.0 * torch.log10(torch.clamp(mse, min=1e-12))}
            if "num_live_samples" in out:
                metrics["num_samples"] = out["num_live_samples"]
        return metrics


def grid_update(grid: occupancy.OccupancyGrid, field: NerfField, rng: Draws,
                cfg: NerfConfig) -> occupancy.OccupancyGrid:
    """Probe the density at one jittered point a cell (draw "cell_jitter",
    (R^3, 3) uniforms) and EMA-merge it into the grid."""
    res = grid.resolution
    dev = grid.density.device
    ii = torch.arange(res, device=dev)
    cells = torch.stack(torch.meshgrid(ii, ii, ii, indexing="ij"), -1).reshape(-1, 3)
    u = (cells.to(torch.float32) + uniform(rng, "cell_jitter", cells.shape, dev)) / res
    lo, hi = grid.aabb[0], grid.aabb[1]
    pos = lo + u * (hi - lo)
    # density only; the direction does not reach it in any field here
    dirs = torch.tensor([0.0, 0.0, -1.0], device=dev).expand(pos.shape)
    with torch.no_grad(), full_f32():
        dens = _field(field, cfg, pos, dirs)[0]
    return occupancy.update_grid(grid, pos, dens[..., 0])


class NerfTrainer:
    def __init__(self, config: NerfTrainerConfig, dm: FullImageDatamanager):
        self.config = config
        self.dm = dm
        self.device = dm.device
        self.field: Optional[NerfField] = None
        self.opt: Optional[Dict] = None
        self.grid: Optional[occupancy.OccupancyGrid] = None
        self.sizer: Optional[DynamicBatchSizer] = None
        self.draws: Optional[Callable[[str, int], Draws]] = None
        self.history: list = []  # each step's metrics as floats
        self.start_step = 0
        self._views: Dict[int, Dict[str, torch.Tensor]] = {}
        # dnerf: per-frame times from the parser, or a ramp over the capture
        meta = dm.outputs.metadata
        n = len(dm)
        if config.model.deformation:
            self.times = np.asarray(meta.get("times", np.linspace(0.0, 1.0, max(n, 2))[:n]),
                                    np.float32)
        else:
            self.times = np.zeros(n, np.float32)

    def setup(self) -> NerfField:
        c = self.config
        self.field = init_nerf(c.model, seed=c.seed, device=self.device)
        self.opt = init_adam(self.field)
        self.rng = np.random.default_rng(c.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(c.seed)
        if c.use_occupancy_grid:
            s = c.model.scene_scale
            self.grid = occupancy.init_grid([[-s, -s, -s], [s, s, s]],
                                            resolution=c.grid_resolution, device=self.device)
        if c.dynamic_batch:
            self.sizer = DynamicBatchSizer(
                target_num_samples=c.target_num_samples,
                max_num_samples_per_ray=c.model.num_coarse + c.model.num_fine)
        return self.field

    def _rng(self, kind: str, num_rays: int) -> Draws:
        return self.generator if self.draws is None else self.draws(kind, num_rays)

    def _view(self, idx: int) -> Dict[str, torch.Tensor]:
        """View idx's image, depth and SAM labels on the device, copied once."""
        if idx not in self._views:
            data = self.dm.view_data(idx)
            self._views[idx] = {k: torch.as_tensor(data[k]).to(self.device)
                                for k in ("image", "depth", "sam_mask")}
        return self._views[idx]

    def train(self) -> NerfField:
        c = self.config
        writer = MetricsWriter(steps_per_log=c.steps_per_log, max_steps=c.max_iterations)
        n = len(self.dm)
        weights = loss_weights(c)
        sampler = make_pixel_sampler(c.pixel_sampler, c.rays_per_batch,
                                     patch_size=c.patch_size, pair_radius=c.pair_radius)
        for step in range(self.start_step, c.max_iterations):
            if self.sizer is not None and self.sizer.num_rays != sampler.rays_per_batch:
                sampler = make_pixel_sampler(c.pixel_sampler, self.sizer.num_rays,
                                             patch_size=c.patch_size, pair_radius=c.pair_radius)
            idx = int(self.rng.integers(0, n))
            cam = self.dm.camera(idx)
            view = self._view(idx)
            pix = sampler.sample(self.rng, cam.height, cam.width)
            coords = torch.as_tensor(pix, dtype=torch.int64).to(self.device)
            ys, xs = coords[:, 0], coords[:, 1]
            if self.grid is not None and step % c.grid_update_every == 0:
                self.grid = grid_update(self.grid, self.field, self._rng("grid", len(pix)), c.model)
            metrics = nerf_step(
                self.field, self.opt, cam, coords, view["image"][ys, xs], view["depth"][ys, xs],
                view["sam_mask"][ys, xs], torch.tensor(float(self.times[idx]), device=self.device),
                idx % max(c.model.num_appearance_embeds, 1), self.grid,
                self._rng("step", len(pix)), c.model, c.lr, weights, step=step)
            if self.sizer is not None:
                measured = metrics.get("num_samples")
                # a dense renderer: every sample lives
                measured = (len(pix) * (c.model.num_coarse + c.model.num_fine)
                            if measured is None else int(measured))
                self.sizer.update(measured)
                metrics["num_rays_per_batch"] = sampler.rays_per_batch
            with PROFILER.section("history"):
                self.history.append({k: float(v) for k, v in metrics.items()})
            writer.step(step, metrics, pixels=len(pix))
            if (step + 1) % c.steps_per_save == 0 or step + 1 == c.max_iterations:
                print(f"saved {self._save(step + 1)}")
        return self.field

    def _save(self, step: int) -> Path:
        ckpt_dir = self.config.run_dir / "checkpoints"
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        path = ckpt_dir / STEP_FMT.format(step)
        cpu = lambda tree: {k: v.detach().cpu() for k, v in tree.items()}  # noqa: E731
        torch.save({
            "step": step,
            "model_config": dataclasses.asdict(self.config.model),
            "field": cpu(self.field.state_dict()),
            "opt": {"mu": cpu(self.opt["mu"]), "nu": cpu(self.opt["nu"]),
                    "count": self.opt["count"].cpu()},
            "grid": None if self.grid is None else {
                "density": self.grid.density.cpu(), "aabb": self.grid.aabb.cpu(),
                "threshold": self.grid.threshold},
            "sizer": None if self.sizer is None else {"ideal": self.sizer._ideal,
                                                      "num_rays": self.sizer.num_rays},
            "rng": self.rng.bit_generator.state,
            "generator": self.generator.get_state(),
        }, path)
        return path

    def load(self, path: Path) -> int:
        """Resume from a checkpoint that `_save` wrote (after `setup`):
        field, Adam moments, grid, sizer and both generators. Returns the
        step that training continues from. A checkpoint written on another
        kind of device holds a generator state this device cannot take, and
        raises."""
        payload = torch.load(Path(path), map_location="cpu", weights_only=True)
        dev = self.device
        self.field.load_state_dict(payload["field"])
        self.opt = {"mu": {k: v.to(dev) for k, v in payload["opt"]["mu"].items()},
                    "nu": {k: v.to(dev) for k, v in payload["opt"]["nu"].items()},
                    "count": payload["opt"]["count"].to(dev)}
        if payload["grid"] is not None:
            g = payload["grid"]
            self.grid = occupancy.OccupancyGrid(g["density"].to(dev), g["aabb"].to(dev),
                                                float(g["threshold"]))
        if payload["sizer"] is not None:
            self.sizer._ideal = payload["sizer"]["ideal"]
            self.sizer.num_rays = payload["sizer"]["num_rays"]
        self.rng.bit_generator.state = payload["rng"]
        saved = payload["generator"]
        if saved.numel() != self.generator.get_state().numel():
            raise ValueError(f"{path}: its torch generator state ({saved.numel()} bytes) is "
                             f"not one a {self.device.type} generator takes; resume it on the "
                             "kind of device that wrote it")
        self.generator.set_state(saved)
        self.start_step = int(payload["step"])
        return self.start_step

    def render_image(self, camera: Camera, chunk: int = 4096,
                     time_value: float = 0.0) -> torch.Tensor:
        """Full-image render in ray chunks, each chunk drawing from a
        generator seeded with 0 (the JAX package renders with one fixed key):
        (H, W, 3)."""
        rb = generate_rays(camera)
        flat = rb.map(lambda x: x.reshape(-1, x.shape[-1]))
        total = flat.origins.shape[0]
        t = torch.tensor(time_value, device=self.device)
        outs = []
        with torch.no_grad(), full_f32():
            for i in range(0, total, chunk):
                sl = flat.map(lambda x: x[i:i + chunk])
                gen = torch.Generator(device=self.device).manual_seed(0)
                outs.append(render_rays(self.field, sl, gen, self.config.model, grid=self.grid,
                                        times=t)["rgb"])
        return torch.cat(outs).reshape(camera.height, camera.width, 3)
