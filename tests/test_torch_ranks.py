"""Rank bodies for the port's gloo tests in tests/test_torch_parallel.py;
this module holds no test of its own.

Spawned ranks import this module by name, so it imports torch and the
port only (no JAX): each rank starts in a fresh interpreter. Every body
takes (rank, store_dir, ...) as `comm.run_world` passes them and writes
its results with torch.save under `out_dir`.
"""

from pathlib import Path

import torch

from gaussiangrasper_torch.core.cameras import Camera
from gaussiangrasper_torch.engine import checkpoint as ckpt
from gaussiangrasper_torch.engine.weights import train_state_from_numpy
from gaussiangrasper_torch.models.model import GaussianSplatConfig
from gaussiangrasper_torch.ops.projection import ProjectedGaussians
from gaussiangrasper_torch.ops.rasterize import RasterizeConfig
from gaussiangrasper_torch.parallel import comm
from gaussiangrasper_torch.parallel.tile_shard import composite_tile_sharded
from gaussiangrasper_torch.parallel.train import gather_train_state, make_sharded_train_step
from gaussiangrasper_torch.parallel.train import shard_train_state


def composite_loss(image, alpha, target):
    """The loss both the sharded and the unsharded composites are
    differentiated through."""
    return torch.abs(image - target).mean() + alpha.mean()


def composite(mesh, scene: dict, raster: dict, tag: str, out: Path) -> None:
    """composite_tile_sharded on this rank's rows of `scene` (numpy xys,
    conics, cov2d, depths, radii, opacities, colors, background, target,
    width, height) and the gradient of `composite_loss` w.r.t. the rank's
    xys, conics, opacities and colours."""
    d, r = mesh.shape["gauss"], mesh.coords["gauss"]
    n = scene["xys"].shape[0]
    rows = slice(r * n // d, (r + 1) * n // d)
    t = {k: torch.as_tensor(scene[k][rows]) for k in
         ("xys", "conics", "cov2d", "depths", "radii", "opacities", "colors")}
    leaves = [t[k].clone().requires_grad_(True) for k in ("xys", "conics", "opacities", "colors")]
    proj = ProjectedGaussians(xys=leaves[0], depths=t["depths"], conics=leaves[1],
                              radii=t["radii"], cov2d=t["cov2d"])
    res = composite_tile_sharded(proj, leaves[3], leaves[2], torch.as_tensor(scene["background"]),
                                 scene["width"], scene["height"], RasterizeConfig(**raster),
                                 mesh=mesh)
    loss = composite_loss(res["image"], res["alpha"], torch.as_tensor(scene["target"]))
    grads = torch.autograd.grad(loss, leaves)
    torch.save({"image": res["image"].detach(), "alpha": res["alpha"].detach(),
                "bins": {k: int(v) for k, v in res["bins"]._asdict().items()},
                "grads": [g.detach() for g in grads]}, out / f"{tag}_rank{mesh.coords['gauss']}.pt")


def sharded_step(mesh, case: dict, tag: str, out: Path) -> None:
    """One make_sharded_train_step step from the numpy state of `case`
    (train_state_from_numpy's arguments under "state"), this rank's camera
    and batch (its dp coordinate); rank 0 saves the gathered state and
    the metrics."""
    cfg = GaussianSplatConfig(raster=RasterizeConfig(**case["raster"]), **case["model"])
    whole = train_state_from_numpy(**case["state"])
    local = shard_train_state(whole, mesh)
    step = make_sharded_train_step(mesh, cfg, whole.field.capacity,
                                   tile_shard=case["tile_shard"])
    i = mesh.coords["dp"]
    cam = Camera.create(*case["intrinsics"], case["c2w"], *case["size"])
    batch = {k: torch.as_tensor(v[i]) for k, v in case["batches"].items()}
    local, metrics = step(local, cam, batch)
    whole = gather_train_state(local, mesh)
    if torch.distributed.get_rank() == 0:
        ckpt.save_checkpoint(out / tag, whole)
        torch.save({k: v.detach() for k, v in metrics.items()}, out / f"{tag}_metrics.pt")


def world(rank: int, store_dir: str, size: int, jobs: list, out: str) -> None:
    """Run `jobs` — ("composite", dp, gauss, args) or ("step", dp, gauss,
    args) with dp x gauss == size — in one gloo world of `size` ranks."""
    out = Path(out)
    try:
        for kind, dp, gauss, args in jobs:
            mesh = comm.init_world(dp, gauss, "cpu", rank=rank, store_dir=store_dir)
            {"composite": composite, "step": sharded_step}[kind](mesh, *args, out)
    finally:
        comm.close_world()
