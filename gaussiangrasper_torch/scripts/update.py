"""Scene update: move an object's Gaussians, then fine-tune (counterpart of
the JAX package's scripts/update.py).

Loads a trainer run, selects the Gaussians inside the convex hull of the
edited object's point cloud (Delaunay `find_simplex` after the reference's
outlier filter), moves their means and quats rigidly, saves that state as
<run>/edit/checkpoints/step_000000000.pt and fine-tunes it on the
post-move capture with the reference's refine settings (warmup 300,
densify_grad_thresh 1e-3, refine_every 200, 580 iterations by default).
The fine-tune's own run is <run>/edit/finetune; the result is also saved
as <run>/edit/checkpoints/step_009999999.pt.

The move is a 4x4 matrix (--transform-npy) or two 6-dof poses
(--pose-before / --pose-after, x y z rx ry rz rotvec), T = T_after @
T_before^-1, in the capture frame.

    python -m gaussiangrasper_torch.scripts.update --run-dir RUN \\
        --edit-object obj.npy --transform-npy move.npy [--mesh dp,gauss] [--device cpu]

With --mesh the fine-tune runs through the sharded host loop, as the JAX
CLI's does.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import torch

from gaussiangrasper_torch._device import resolve_device
from gaussiangrasper_torch.core.transforms import quat_to_rotmat, rotmat_to_quat
from gaussiangrasper_torch.engine import checkpoint as ckpt
from gaussiangrasper_torch.engine.trainer import make_trainer
from gaussiangrasper_torch.models.gaussian_field import GaussianParams
from gaussiangrasper_torch.scripts.common import load_run


def points_inside_convex_hull(points: np.ndarray, hull_points: np.ndarray,
                              remove_outliers: bool = True,
                              outlier_factor: float = 1.0) -> np.ndarray:
    """Mask of `points` inside the convex hull of `hull_points`. The
    outlier filter is the reference's: an "IQR" from the 0th and 80th
    percentiles."""
    from scipy.spatial import Delaunay

    if remove_outliers:
        q1 = np.percentile(hull_points, 0, axis=0)
        q3 = np.percentile(hull_points, 80, axis=0)
        iqr = q3 - q1
        bad = (hull_points < (q1 - outlier_factor * iqr)) | (
            hull_points > (q3 + outlier_factor * iqr))
        hull_points = hull_points[~np.any(bad, axis=1)]
    return Delaunay(hull_points).find_simplex(points) >= 0


def rigid_transform_gaussians(field: GaussianParams, mask: torch.Tensor,
                              transform: np.ndarray) -> GaussianParams:
    """The masked Gaussians moved by a 4x4 rigid transform on the field's
    device: means' = R m + t, quat' = quat(R @ R(quat))."""
    dev = field.means.device
    r = torch.as_tensor(transform[:3, :3], dtype=torch.float32, device=dev)
    t = torch.as_tensor(transform[:3, 3], dtype=torch.float32, device=dev)
    m = mask.to(dev)[:, None]
    rots = torch.einsum("ij,njk->nik", r, quat_to_rotmat(field.quats))
    return field._replace(means=torch.where(m, field.means @ r.T + t, field.means),
                          quats=torch.where(m, rotmat_to_quat(rots), field.quats))


def pose_to_matrix(vec: np.ndarray) -> np.ndarray:
    """6-dof (x y z rx ry rz) rotvec pose -> 4x4."""
    from scipy.spatial.transform import Rotation

    m = np.eye(4)
    m[:3, :3] = Rotation.from_rotvec(vec[3:]).as_matrix()
    m[:3, 3] = vec[:3]
    return m


def main(argv=None):
    """Edit and fine-tune; returns the fine-tune's Trainer."""
    p = argparse.ArgumentParser(description="Edit a trained scene and fine-tune")
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--edit-object", type=Path, required=True,
                   help=".npy/.txt (N,3+) object points in capture frame")
    p.add_argument("--transform-npy", type=Path, default=None,
                   help="4x4 rigid move of the object, capture frame")
    p.add_argument("--pose-before", type=float, nargs=6, default=None)
    p.add_argument("--pose-after", type=float, nargs=6, default=None)
    p.add_argument("--after-data", type=Path, default=None,
                   help="post-move capture dir (default <data>/../after_updating)")
    p.add_argument("--max-iterations", type=int, default=580)
    p.add_argument("--mesh", type=str, default=None,
                   help="'dp,gauss' mesh: run the fine-tune through the sharded host loop "
                        "on dp x gauss ranks (parallel/host_loop.py)")
    p.add_argument("--tile-shard", type=str, default="auto", choices=("auto", "on", "off"),
                   help="with --mesh: composite each camera in bands over the gauss ranks "
                        "(auto: on when gauss > 1)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    config, trainer, state = load_run(args.run_dir, device=device)
    dm = trainer.dm
    world_t = np.eye(4)
    world_t[:3] = dm.outputs.dataparser_transform
    scale = dm.outputs.dataparser_scale

    # object points: capture frame -> oriented, scaled world frame
    if args.edit_object.suffix == ".npy":
        obj = np.load(args.edit_object)[:, :3]
    else:
        obj = np.loadtxt(args.edit_object)[:, :3]
    obj_w = (obj @ world_t[:3, :3].T + world_t[:3, 3]) * scale

    # the rigid move, conjugated from the capture frame into the world frame
    if args.transform_npy is not None:
        move = np.load(args.transform_npy)
    elif args.pose_before is not None and args.pose_after is not None:
        move = pose_to_matrix(np.array(args.pose_after)) @ np.linalg.inv(
            pose_to_matrix(np.array(args.pose_before)))
    else:
        raise SystemExit("give --transform-npy or --pose-before/--pose-after")
    move_w = world_t @ move @ np.linalg.inv(world_t)
    move_w[:3, 3] *= scale

    alive = state.alive.cpu().numpy()
    mask = points_inside_convex_hull(state.field.means.detach().cpu().numpy(), obj_w) & alive
    if not mask.any():
        raise SystemExit("no gaussians inside the edited-object hull")
    print(f"transforming {int(mask.sum())} / {int(alive.sum())} gaussians")

    # means and quats move; the Adam moments and densify stats stay
    state = dataclasses.replace(
        state, step=0,
        field=rigid_transform_gaussians(state.field, torch.as_tensor(mask), move_w))

    edit_dir = args.run_dir / "edit"
    ckpt.save_checkpoint(edit_dir / "checkpoints", state, step=0, keep_only_latest=False)

    ft_config = dataclasses.replace(
        config,
        data=args.after_data or (Path(config.data).parent / "after_updating"),
        max_iterations=args.max_iterations,
        output_dir=edit_dir,
        experiment_name="finetune",
        model=dataclasses.replace(config.model, warmup_length=300, densify_grad_thresh=1e-3,
                                  refine_every=200),
    )
    ft_trainer = make_trainer(ft_config, device=device)
    ft_trainer.setup()
    ft_trainer.state = state
    if args.mesh:
        from gaussiangrasper_torch.configs.methods import parse_mesh, parse_tile_shard
        from gaussiangrasper_torch.parallel.host_loop import train_sharded

        dp, gauss = parse_mesh(args.mesh)
        state = train_sharded(ft_trainer, dp=dp, gauss=gauss,
                              tile_shard=parse_tile_shard(args.tile_shard))
    else:
        state = ft_trainer.train()
    # the step-0 state stays beside the result, as the reference keeps it
    path = ckpt.save_checkpoint(edit_dir / "checkpoints", state, step=9999999,
                                keep_only_latest=False)
    print(f"edited scene saved to {path}")
    return ft_trainer


if __name__ == "__main__":
    main()
