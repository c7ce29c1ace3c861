"""Method registry: name -> trainer factory (counterpart of the JAX
package's configs/methods.py, the `gaussian-splatting` entry).

The JAX package's NeRF zoo and generfacto are not ported yet: their names
raise NotImplementedError (ROADMAP.md, Queue 1 item 4), as do several
`--data` dirs (multi-scene training) and `--mesh` (sharded training),
Queue 1 item 3.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

NOT_PORTED = ("nerfacto", "nerfacto-big", "nerfacto-huge", "vanilla-nerf", "depth-nerfacto",
              "mipnerf", "instant-ngp", "instant-ngp-bounded", "tensorf", "dnerf",
              "semantic-nerfw", "phototourism", "neus", "neus-facto", "generfacto")
"""The JAX package's other registered methods."""


def _gaussian_splatting(args):
    """Single-scene Gaussian splatting; returns the trained Trainer."""
    from gaussiangrasper_torch.engine.trainer import TrainerConfig, make_trainer
    from gaussiangrasper_torch.models.model import GaussianSplatConfig

    if len(args.data) > 1:
        raise NotImplementedError("multi-scene training (several --data dirs) is not ported to "
                                  "gaussiangrasper_torch yet (ROADMAP.md, Queue 1 item 3)")
    if getattr(args, "mesh", None):
        raise NotImplementedError("--mesh (sharded training) is not ported to "
                                  "gaussiangrasper_torch yet (ROADMAP.md, Queue 1 item 3)")
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
    trainer = make_trainer(config, device=getattr(args, "device", None))
    trainer.setup()
    trainer.train()
    return trainer


METHODS: Dict[str, Callable] = {"gaussian-splatting": _gaussian_splatting}


def get_method(name: str) -> Callable:
    if name in NOT_PORTED:
        raise NotImplementedError(f"method {name!r} is not ported to gaussiangrasper_torch yet "
                                  "(ROADMAP.md, Queue 1 item 4: the NeRF zoo)")
    if name not in METHODS:
        raise KeyError(f"unknown method {name!r}; have {sorted(METHODS)}")
    return METHODS[name]
