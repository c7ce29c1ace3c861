"""Host training loop (counterpart of the JAX package's engine/trainer.py).

`Trainer.setup` initializes the field from the dataparser's seed points (or
at random), the `fea_up` MLP and the optimizer state; `Trainer.train` runs
the loop: a batch from the datamanager (prefetched by a worker thread),
the coarse-to-fine downscale on the device, the view's index (`cam_idx`,
which picks its pose delta when `model.pose_opt_mode` is not "off"),
`train_step`, the non-finite check every 10 steps, `refine_step` every
`refine_every` steps, metrics and a checkpoint every `steps_per_save` steps
and at the end. All device work is in `train_state.train_step` /
`train_state.refine_step`. `viewer_port` serves the live state through
`scripts/viewer.py` while the loop runs (renders time-shared with
training); `profiler="trace"` writes a `torch.profiler` trace of steps
12..16, with the loop's and the step's `ggt::` spans, under
`<run_dir>/profiler_traces/`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from gaussiangrasper_torch.core.cameras import Camera
from gaussiangrasper_torch.core.pose_opt import init_pose_deltas
from gaussiangrasper_torch.data.manager import FullImageDatamanager, SamplerConfig
from gaussiangrasper_torch.engine import checkpoint as ckpt
from gaussiangrasper_torch.engine import train_state
from gaussiangrasper_torch.engine.train_state import TrainState, init_train_state
from gaussiangrasper_torch.models.gaussian_field import init_from_seeds, init_random
from gaussiangrasper_torch.models.model import GaussianSplatConfig
from gaussiangrasper_torch.utils.profiler import PROFILER
from gaussiangrasper_torch.utils.writer import MetricsWriter


@dataclasses.dataclass
class TrainerConfig:
    """The JAX package's TrainerConfig: the same fields and defaults, so a
    `config.json` written by either package loads in the other."""

    data: Path = Path("data")
    output_dir: Path = Path("outputs")
    experiment_name: str = "gaussian-splatting"
    max_iterations: int = 30000
    steps_per_save: int = 2000
    steps_per_log: int = 10
    steps_per_eval_image: int = 100
    seed: int = 42
    capacity_multiplier: float = 8.0
    """Field capacity = multiplier x seed count (densification headroom)."""
    capacity: Optional[int] = None
    random_init_points: int = 50000
    tensorboard: bool = False
    vis: str = ""
    """Extra metric backends, '+'-separated: any of tensorboard, wandb,
    comet. Backends whose library is missing degrade with a notice."""
    prefetch: bool = True
    """Prepare the next host batches on a worker thread."""
    viewer_port: Optional[int] = None
    """Serve the live state on this port (scripts/viewer.py) while training."""
    load_dir: Optional[Path] = None
    profiler: str = "none"
    """"trace": a torch.profiler trace of steps 12..16 (utils/profiler.py)."""
    dataparser: str = "auto"
    """Named dataparser from data/dataparsers/zoo.py, or auto-detect."""
    model: GaussianSplatConfig = dataclasses.field(default_factory=GaussianSplatConfig)

    @property
    def run_dir(self) -> Path:
        return Path(self.output_dir) / self.experiment_name

    @property
    def ckpt_dir(self) -> Path:
        return self.run_dir / "checkpoints"


def _downscale_factor(cfg: GaussianSplatConfig, step: int) -> int:
    """2^max(num_downscales - step // resolution_schedule, 0)."""
    return 2 ** max(cfg.num_downscales - step // cfg.resolution_schedule, 0)


def downscale_batch(batch: Dict[str, torch.Tensor], cam: Camera,
                    d: int) -> Tuple[Camera, Dict[str, torch.Tensor]]:
    """Coarse-to-fine on the device: shrink image, depth and normal
    bilinearly (half-pixel centres, no antialiasing: OpenCV's INTER_LINEAR)
    and the valid mask by nearest neighbour to (H // d, W // d), as the JAX
    package's cv2.resize does, and rescale the sampled pixel indices into
    the shrunken frame."""
    if d == 1:
        return cam, batch
    h2, w2 = batch["image"].shape[0] // d, batch["image"].shape[1] // d

    def shrink(a: torch.Tensor, mode: str) -> torch.Tensor:
        x = a.float()
        x = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
        kw = {"align_corners": False, "antialias": False} if mode == "bilinear" else {}
        y = F.interpolate(x, size=(h2, w2), mode=mode, **kw)
        return y[0, 0] if a.ndim == 2 else y[0].permute(1, 2, 0).contiguous()

    out = dict(batch)
    for k in ("image", "depth", "normal"):
        out[k] = shrink(batch[k], "bilinear")
    out["valid_mask"] = shrink(batch["valid_mask"], "nearest") > 0.5
    top = torch.tensor([h2 - 1, w2 - 1], dtype=torch.int32, device=batch["image"].device)
    for k in ("pair_a", "pair_b", "points"):
        out[k] = torch.minimum(batch[k] // d, top)
    return cam.rescale(1.0 / d), out


def _uniform(gen: torch.Generator, shape, low: float = 0.0, high: float = 1.0):
    return (torch.rand(shape, generator=gen) * (high - low) + low).numpy()


def _config_payload(cfg: TrainerConfig) -> dict:
    def plain(v):
        if isinstance(v, Path):
            return str(v)
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        return v

    return plain(dataclasses.asdict(cfg))


class Trainer:
    def __init__(self, config: TrainerConfig, datamanager: FullImageDatamanager):
        self.config = config
        self.dm = datamanager
        self.writer: Optional[MetricsWriter] = None
        self.state: Optional[TrainState] = None
        self.data_wait_s: List[float] = []
        """Host seconds each step of the last `train` waited on its batch."""
        self.viewer = None
        """The live viewer's server while `train` runs with `viewer_port`
        (its `.throttle` keeps the renders' share of wall time)."""

    @property
    def device(self) -> torch.device:
        return self.dm.device

    def setup(self) -> TrainState:
        """The initial state (or the latest checkpoint under `load_dir`).
        Every draw comes from one CPU torch.Generator seeded with `seed`, in
        a fixed order (field, then fea_up), so the init is the same on any
        device."""
        cfg = self.config
        mcfg = cfg.model
        gen = torch.Generator().manual_seed(cfg.seed)
        fd = mcfg.feature_dim

        seeds = self.dm.seed_points
        if seeds is not None:
            xyz, rgb = seeds
            n = len(xyz)
            cap = cfg.capacity or int(n * cfg.capacity_multiplier)
            draws = {"quats": _uniform(gen, (3, n)), "features": _uniform(gen, (n, fd))}
            field, alive = init_from_seeds(xyz, rgb, draws, sh_degree=mcfg.sh_degree,
                                           capacity=cap, device=self.device)
        else:
            n = cfg.random_init_points
            cap = cfg.capacity or int(n * cfg.capacity_multiplier)
            draws = {"means": _uniform(gen, (n, 3)), "rgb": _uniform(gen, (n, 3)),
                     "quats": _uniform(gen, (3, n)), "features": _uniform(gen, (n, fd))}
            field, alive = init_random(draws, sh_degree=mcfg.sh_degree, capacity=cap,
                                       device=self.device)
        # torch.nn.Linear's default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias
        dims = [fd, 128, mcfg.clip_dim]
        fea_up = {}
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            bound = 1.0 / math.sqrt(d_in)
            for name, shape in (("weight", (d_out, d_in)), ("bias", (d_out,))):
                fea_up[f"layers.{i}.{name}"] = torch.as_tensor(
                    _uniform(gen, shape, -bound, bound), device=self.device)
        pose = None
        if mcfg.pose_opt_mode != "off":
            pose = init_pose_deltas(len(self.dm), device=self.device)
        state = init_train_state(field, alive, fea_up, seed=cfg.seed, pose=pose)

        if cfg.load_dir is not None:
            path = ckpt.latest_checkpoint(cfg.load_dir)
            if path is not None:
                state = ckpt.load_checkpoint(path, self.device)
                print(f"resumed from {path} at step {state.step}")

        self.writer = MetricsWriter(
            log_dir=cfg.run_dir / "tb", tensorboard=cfg.tensorboard,
            steps_per_log=cfg.steps_per_log, max_steps=cfg.max_iterations,
            vis=[v for v in cfg.vis.split("+") if v],
            experiment_name=cfg.experiment_name,
        )
        self.state = state
        self.save_config()
        return state

    def save_config(self) -> None:
        cfg = self.config
        cfg.run_dir.mkdir(parents=True, exist_ok=True)
        (cfg.run_dir / "config.json").write_text(json.dumps(_config_payload(cfg), indent=2))

    def _eval_image(self, state: TrainState, step: int) -> None:
        """Render view 0 into the metric backends (its cached camera: no
        draw from the sampling generator)."""
        from gaussiangrasper_torch.models.model import render

        with torch.no_grad():
            outs = render(state.field, state.alive, self.dm.camera(0), state.step,
                          self.config.model)
        self.writer.image(step, "eval/rgb", outs["rgb"].clamp(0, 1).cpu().numpy())

    def train(self) -> TrainState:
        """Run the loop from the state's step to `max_iterations`. Under a
        recording `torch.profiler` (`profiler="trace"`, say) each stage is a
        `ggt::` span (utils/profiler.py): data_wait, downscale, train_step
        (with its own children), loss_check, refine, log, eval_image, save."""
        cfg = self.config
        mcfg = cfg.model
        if self.state is None:
            self.setup()
        if self.writer is None:
            self.writer = MetricsWriter(steps_per_log=cfg.steps_per_log,
                                        max_steps=cfg.max_iterations)
        state = self.state
        num_train = len(self.dm)

        source = self.dm
        prefetcher = None
        if cfg.prefetch and cfg.max_iterations - state.step > 1:
            from gaussiangrasper_torch.data.prefetch import PrefetchingDatamanager

            prefetcher = source = PrefetchingDatamanager(self.dm)

        self.data_wait_s = []
        start = state.step
        t0 = time.perf_counter()
        viewer = tracer = None
        try:
            if cfg.viewer_port is not None:
                from gaussiangrasper_torch.scripts.viewer import scene_info_from_dm, serve_in_background

                viewer = self.viewer = serve_in_background(
                    lambda: self.state, mcfg, cfg.viewer_port,
                    scene_info=scene_info_from_dm(self.dm), out_dir=cfg.run_dir / "renders")
            if cfg.profiler == "trace":
                from gaussiangrasper_torch.utils.profiler import TraceCapture

                tracer = TraceCapture(cfg.run_dir / "profiler_traces", device=self.device)
            for step in range(start, cfg.max_iterations):
                if tracer is not None:
                    tracer.maybe_step(step)
                t_wait = time.perf_counter()
                with PROFILER.section("data_wait"):
                    cam_idx, cam, batch = source.next_train()
                self.data_wait_s.append(time.perf_counter() - t_wait)
                with PROFILER.section("downscale"):
                    cam_s, batch_s = downscale_batch(batch, cam, _downscale_factor(mcfg, step))
                if state.pose is not None:
                    batch_s = dict(batch_s, cam_idx=cam_idx)
                state, metrics = train_state.train_step(state, cam_s, batch_s, mcfg)
                self.state = state

                # a non-finite loss poisons the run: save a post-mortem
                # checkpoint and stop instead of training on NaNs
                if step % 10 == 0:
                    with PROFILER.section("loss_check"):
                        finite = math.isfinite(float(metrics["loss"]))
                    if not finite:
                        path = ckpt.save_checkpoint(cfg.ckpt_dir, state, step=step)
                        raise FloatingPointError(
                            f"non-finite loss at step {step}; post-mortem state saved to {path}")

                if (step + 1) % mcfg.refine_every == 0:
                    with PROFILER.section("refine"):
                        state = train_state.refine_step(state, mcfg, cam_s.width, cam_s.height,
                                                        num_train)
                    self.state = state

                with PROFILER.section("log"):
                    self.writer.step(step,
                                     {k: metrics[k] for k in ("loss", "psnr", "gaussian_count")},
                                     pixels=cam_s.width * cam_s.height)
                if self.writer.has_backend and (step + 1) % cfg.steps_per_eval_image == 0:
                    with PROFILER.section("eval_image"):
                        self._eval_image(state, step)
                if (step + 1) % cfg.steps_per_save == 0 or step + 1 == cfg.max_iterations:
                    with PROFILER.section("save"):
                        path = ckpt.save_checkpoint(cfg.ckpt_dir, state)
                    print(f"saved {path}")
        finally:
            if tracer is not None:
                tracer.close()
            if prefetcher is not None:
                prefetcher.close()
            if viewer is not None:
                viewer.throttle.training = False
                viewer.shutdown()
                viewer.server_close()
        dt = time.perf_counter() - t0
        steps_done = cfg.max_iterations - start
        if steps_done:
            print(f"trained {steps_done} steps in {dt:.1f}s ({steps_done / dt:.2f} it/s)")
        self.state = state
        return state


def make_trainer(config: TrainerConfig, device=None) -> Trainer:
    """Datamanager (resolving the named or auto-detected dataparser) and
    trainer, on `device` (None means cuda)."""
    from gaussiangrasper_torch.data.dataparsers.zoo import resolve_parser

    outputs = resolve_parser(Path(config.data), config.dataparser).parse()
    dm = FullImageDatamanager(outputs, SamplerConfig(), seed=config.seed, device=device)
    return Trainer(config, dm)
