"""Method registry: name -> trainer factory (counterpart of the JAX
package's configs/methods.py, the `gaussian-splatting` entry).

Several `--data` dirs train the scenes together (engine/multi_scene.py;
with `--mesh dp,gauss`, over dp ranks), one dir with `--mesh` trains
sharded (parallel/host_loop.py). The JAX package's NeRF zoo and
generfacto are not ported yet: their names raise NotImplementedError
(ROADMAP.md, Queue 1 item 3).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

NOT_PORTED = ("nerfacto", "nerfacto-big", "nerfacto-huge", "vanilla-nerf", "depth-nerfacto",
              "mipnerf", "instant-ngp", "instant-ngp-bounded", "tensorf", "dnerf",
              "semantic-nerfw", "phototourism", "neus", "neus-facto", "generfacto")
"""The JAX package's other registered methods."""


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


METHODS: Dict[str, Callable] = {"gaussian-splatting": _gaussian_splatting}


def get_method(name: str) -> Callable:
    if name in NOT_PORTED:
        raise NotImplementedError(f"method {name!r} is not ported to gaussiangrasper_torch yet "
                                  "(ROADMAP.md, Queue 1 item 3: the NeRF zoo)")
    if name not in METHODS:
        raise KeyError(f"unknown method {name!r}; have {sorted(METHODS)}")
    return METHODS[name]
