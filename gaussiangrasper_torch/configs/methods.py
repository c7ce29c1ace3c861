"""Method registry: name -> trainer factory (counterpart of the JAX
package's configs/methods.py).

`gaussian-splatting`: several `--data` dirs train the scenes together
(engine/multi_scene.py; with `--mesh dp,gauss`, over dp ranks), one dir with
`--mesh` trains sharded (parallel/host_loop.py). The 14 ray-marched names
train a NeRF-family field (engine/nerf_trainer.py) with the JAX package's
settings, then render the first 4 views to renders/<i>.png with
renders/metrics.json (psnr). `generfacto` runs text-to-3D behind the
GGT_GUIDANCE / GGT_GUIDANCE_DIR gate (models/generative.py). Third-party
methods register through the `gaussiangrasper_torch.method_configs`
entry-point group or GGT_METHOD_CONFIGS ("name=module:factory,...").
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
from pathlib import Path
from typing import Callable, Dict


def parse_mesh(mesh: str):
    """'dp,gauss' -> (dp, gauss)."""
    dp, gauss = (int(x) for x in mesh.split(","))
    return dp, gauss


def parse_tile_shard(value: str):
    """'auto' | 'on' | 'off' -> None (on when gauss > 1) | True | False."""
    return None if value == "auto" else value == "on"


def _gaussian_splatting(args):
    """Gaussian splatting: returns the trained Trainer, or with several
    --data dirs the scenes' final states."""
    from gaussiangrasper_torch.engine.trainer import TrainerConfig, make_trainer
    from gaussiangrasper_torch.models.model import GaussianSplatConfig

    model = GaussianSplatConfig(
        feature_dim=args.feature_dim,
        sh_degree=args.sh_degree,
        warmup_length=args.warmup_length,
        refine_every=args.refine_every,
        densify_grad_thresh=args.densify_grad_thresh,
        sky_alpha_reg=getattr(args, "sky_alpha_reg", 0.0),
    )
    mt = getattr(args, "max_tiles_per_gaussian", None)
    if mt:
        model = dataclasses.replace(
            model, raster=dataclasses.replace(model.raster, max_tiles_per_gaussian=mt))
    config = TrainerConfig(
        data=args.data[0],
        output_dir=args.output_dir,
        experiment_name=args.experiment_name,
        max_iterations=args.max_iterations,
        steps_per_save=args.steps_per_save,
        seed=args.seed,
        capacity=args.capacity,
        tensorboard=args.tensorboard,
        vis=getattr(args, "vis", ""),
        viewer_port=getattr(args, "viewer_port", None),
        load_dir=args.load_dir,
        profiler=getattr(args, "profiler", "none"),
        dataparser=getattr(args, "dataparser", "auto"),
        model=model,
    )
    device = getattr(args, "device", None)
    mesh = getattr(args, "mesh", None)
    if len(args.data) > 1:
        from gaussiangrasper_torch.engine.multi_scene import train_multi

        dp = None
        if mesh:
            dp, gauss = parse_mesh(mesh)
            if gauss > 1:
                print(f"multi-scene training splits the scenes over dp={dp}; gauss={gauss} is "
                      "unused, as in the JAX package")
        return train_multi(config, args.data, dp=dp, device=device)
    trainer = make_trainer(config, device=device)
    trainer.setup()
    if mesh:
        from gaussiangrasper_torch.parallel.host_loop import train_sharded

        dp, gauss = parse_mesh(mesh)
        train_sharded(trainer, dp=dp, gauss=gauss,
                      tile_shard=parse_tile_shard(getattr(args, "tile_shard", "auto")))
    else:
        trainer.train()
    return trainer


def _nerf(field: str, model_kwargs: dict | None = None, **trainer_kwargs):
    def run(args):
        """Train, then render the eval views; returns the NerfTrainer."""
        import numpy as np
        import torch

        from gaussiangrasper_torch.data.dataparsers.zoo import resolve_parser
        from gaussiangrasper_torch.data.manager import FullImageDatamanager, SamplerConfig
        from gaussiangrasper_torch.engine.nerf_trainer import NerfTrainer, NerfTrainerConfig
        from gaussiangrasper_torch.models import losses
        from gaussiangrasper_torch.models.nerf import NerfConfig
        from gaussiangrasper_torch.utils.image_io import write_png

        # the GS data path parses and caches the views
        outputs = resolve_parser(Path(args.data[0]), getattr(args, "dataparser", "auto")).parse()
        dm = FullImageDatamanager(outputs, SamplerConfig(), seed=args.seed,
                                  device=getattr(args, "device", None))
        mkw = dict(model_kwargs or {})
        if mkw.pop("_appearance_per_image", False):
            # phototourism: one appearance embedding per training image
            mkw["num_appearance_embeds"] = len(dm)
        cfg = NerfTrainerConfig(
            data=args.data[0],
            output_dir=args.output_dir,
            experiment_name=args.experiment_name,
            max_iterations=args.max_iterations,
            steps_per_save=args.steps_per_save,
            seed=args.seed,
            model=NerfConfig(field=field, **mkw),
            **trainer_kwargs,
        )
        t = NerfTrainer(cfg, dm)
        t.setup()
        t.train()

        # eval render-out (gaussian-splatting runs get this from scripts/render.py)
        out_dir = cfg.run_dir / "renders"
        out_dir.mkdir(parents=True, exist_ok=True)
        rows = []
        for i in range(min(4, len(dm))):
            rgb = torch.clamp(t.render_image(dm.camera(i)), 0, 1)
            write_png(out_dir / f"{i:05d}.png", (rgb.cpu().numpy() * 255).astype(np.uint8))
            gt = torch.as_tensor(dm.view_data(i)["image"], device=rgb.device)
            rows.append({"view": i, "psnr": float(losses.psnr(rgb, gt))})
        (out_dir / "metrics.json").write_text(json.dumps(rows, indent=2))
        print("eval:", rows)
        return t

    return run


def _generfacto(args):
    """Text-to-3D by Score Distillation Sampling (models/generative.py).
    The denoiser is pluggable: GGT_GUIDANCE=color runs the analytic test
    guidance, GGT_GUIDANCE_DIR=<path> wires locally cached diffusion
    weights, and with neither it exits with the install hint. Writes
    <output-dir>/<experiment-name>/generated.png; returns the field."""
    import numpy as np
    import torch

    from gaussiangrasper_torch._device import resolve_device
    from gaussiangrasper_torch.models import generative as gen
    from gaussiangrasper_torch.utils.image_io import write_png

    if os.environ.get("GGT_GUIDANCE") == "color":
        guidance = gen.ColorTargetGuidance()
    elif os.environ.get("GGT_GUIDANCE_DIR"):
        guidance = gen.StableDiffusionGuidance(os.environ["GGT_GUIDANCE_DIR"])
    else:
        raise SystemExit(
            "generfacto requires diffusion-guidance weights "
            "(StableDiffusion/DeepFloyd) which are unavailable in this "
            "environment. Set GGT_GUIDANCE_DIR=<cached weights> to use "
            "them, or GGT_GUIDANCE=color for the analytic scaffold test "
            "guidance (models/generative.py)."
        )
    device = resolve_device(getattr(args, "device", None))
    cfg = gen.GenerfactoConfig(max_iterations=args.max_iterations)
    field, render_view = gen.train_generfacto(
        torch.Generator(device=device).manual_seed(args.seed), guidance, cfg,
        progress=lambda i, l: (i % 50 == 0) and print(f"[{i}] sds={l:.4f}"),
        seed=args.seed, device=device)
    out_dir = Path(args.output_dir) / args.experiment_name
    out_dir.mkdir(parents=True, exist_ok=True)
    cam, _, _ = gen.random_orbit_camera(torch.Generator(device=device).manual_seed(0),
                                        cfg.resolution, radius_mean=cfg.radius_mean,
                                        device=device)
    rgb = torch.clamp(render_view(cam), 0, 1).cpu().numpy()
    write_png(out_dir / "generated.png", (rgb * 255).astype(np.uint8))
    print(f"wrote {out_dir / 'generated.png'}")
    return field


# the JAX package's registered method set
METHODS: Dict[str, Callable] = {
    "gaussian-splatting": _gaussian_splatting,
    "nerfacto": _nerf("nerfacto", {"use_proposal": True}),
    "nerfacto-big": _nerf(
        "nerfacto",
        {"use_proposal": True, "hash_levels": 16, "log2_hashmap_size": 19,
         "num_fine": 96},
    ),
    "nerfacto-huge": _nerf(
        "nerfacto",
        {"use_proposal": True, "hash_levels": 16, "log2_hashmap_size": 21,
         "num_proposal_samples": (256, 96), "num_fine": 128},
    ),
    "vanilla-nerf": _nerf("vanilla", coarse_rgb_lambda=1.0),
    "depth-nerfacto": _nerf("nerfacto", depth_lambda=0.1),
    "mipnerf": _nerf("mipnerf"),
    "instant-ngp": _nerf(
        # trained with a dynamic batch (engine/dynamic_batch.py)
        "instant-ngp", use_occupancy_grid=True, dynamic_batch=True
    ),
    "instant-ngp-bounded": _nerf(
        "instant-ngp", {"scene_scale": 1.0}, use_occupancy_grid=True,
        dynamic_batch=True
    ),
    "tensorf": _nerf("tensorf", tensorf_reg_lambda=5e-4),
    "dnerf": _nerf("vanilla", {"deformation": True}, coarse_rgb_lambda=1.0),
    "semantic-nerfw": _nerf(
        "nerfacto", {"num_semantic_classes": 64}, semantic_lambda=0.1
    ),
    "phototourism": _nerf("nerfacto", {"_appearance_per_image": True}),
    "neus": _nerf("neus", eikonal_lambda=0.1),
    "neus-facto": _nerf("neus-facto", eikonal_lambda=0.1),
    "generfacto": _generfacto,
}


def _load_external() -> None:
    """Entry points and GGT_METHOD_CONFIGS ("name=module:factory,...")."""
    spec = os.environ.get("GGT_METHOD_CONFIGS", "")
    for item in filter(None, spec.split(",")):
        name, target = item.split("=", 1)
        mod, attr = target.split(":", 1)
        METHODS[name] = getattr(importlib.import_module(mod), attr)
    try:
        from importlib.metadata import entry_points

        for ep in entry_points(group="gaussiangrasper_torch.method_configs"):
            METHODS[ep.name] = ep.load()
    except Exception:
        pass


_load_external()


def get_method(name: str) -> Callable:
    if name not in METHODS:
        raise KeyError(f"unknown method {name!r}; have {sorted(METHODS)}")
    return METHODS[name]
