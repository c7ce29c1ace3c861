"""Offline render-out of rgb / CLIP-feature / normal / depth maps
(counterpart of the JAX package's scripts/render.py, dataset views).

The run is either a trainer run (config.json + checkpoints/, written by
`scripts/train.py`; its views and ground truth come from the data dir its
config names, or from --data) or a serving run (checkpoint.pt +
cameras.npz). For up to --num-views of its views, writes
  rgb/<i>.png
  clip/<i>_fea.npy     fea_up-lifted 512-d CLIP map (float16)
  normal/<i>.npy/.png  rotated back to the capture frame by the inverse
                       dataparser rotation
  depth/<i>.npy/.png   metric (divided by the dataparser scale), JET
plus metrics.json (psnr, ssim, psnr_masked, lpips when VGG16 weights are
present (utils/perceptual.py), depth_mae, normal_cos) for the views whose
ground truth the run holds. With --traj interpolate (6
frames from each view towards the next, over every view) or --traj spiral
(--num-views frames around view 0) it renders the camera path's rgb alone
into traj/<i>.png instead.

    python -m gaussiangrasper_torch.scripts.render --run-dir RUN [--traj spiral] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gaussiangrasper_torch._device import resolve_device
from gaussiangrasper_torch.core.camera_paths import interpolate_path, spiral_path
from gaussiangrasper_torch.core.cameras import Camera
from gaussiangrasper_torch.data.dataparsers.base import ParsedCamera
from gaussiangrasper_torch.engine.checkpoint import CHECKPOINT, GT_KEYS, load_cameras, load_run
from gaussiangrasper_torch.engine.weights import ServeState
from gaussiangrasper_torch.models import losses
from gaussiangrasper_torch.models.efd import FeaUp
from gaussiangrasper_torch.models.model import GaussianSplatConfig, render
from gaussiangrasper_torch.utils import perceptual
from gaussiangrasper_torch.utils.image_io import depth2color, write_png
from gaussiangrasper_torch.utils.profiler import PROFILER


def render_view(state: ServeState, cam: Camera, cfg: GaussianSplatConfig) -> Dict:
    """Traced, the span `render_view`, with `render`'s project / bin /
    composite as its children."""
    with PROFILER.section("render_view"), torch.no_grad():
        return render(state.field, state.alive, cam, state.step, cfg)


def lift(fea_up: FeaUp, feature: torch.Tensor) -> torch.Tensor:
    """(H, W, F) rendered features -> (H, W, 512) CLIP space (the span
    `lift`)."""
    with PROFILER.section("lift"), torch.no_grad():
        return fea_up(feature.reshape(-1, feature.shape[-1])).reshape(
            feature.shape[0], feature.shape[1], -1)


def _to_u8(x: np.ndarray) -> np.ndarray:
    return (np.clip(x, 0.0, 1.0) * 255).astype(np.uint8)


def view_metrics(outs: Dict, gt: Dict[str, np.ndarray], i: int, scale: float) -> Dict:
    """The JAX render tool's per-view metrics against view i's ground truth."""
    dev = outs["rgb"].device
    rgb = torch.clamp(outs["rgb"], 0, 1)
    img = torch.as_tensor(gt["image"][i], dtype=torch.float32, device=dev)
    row = {"view": i, "psnr": float(losses.psnr(rgb, img)), "ssim": float(losses.ssim(rgb, img))}
    if "valid_mask" in gt and not gt["valid_mask"][i].all():
        vm = torch.as_tensor(gt["valid_mask"][i], dtype=torch.bool, device=dev)
        row["psnr_masked"] = float(losses.psnr(rgb, img, vm))
    # weight-gated: present only when a VGG16 .npz is at hand
    lp = perceptual.lpips(rgb, img, device=dev)
    if lp is not None:
        row["lpips"] = lp
    if "depth" in gt and gt["depth"][i].max() > 0:
        gt_depth = torch.as_tensor(gt["depth"][i], dtype=torch.float32, device=dev)
        dmask = gt_depth > 0.05
        row["depth_mae"] = float(losses.masked_l1(outs["depth"][..., 0], gt_depth, dmask)) / scale
        if "normal" in gt:
            gt_normal = torch.as_tensor(gt["normal"][i], dtype=torch.float32, device=dev)
            row["normal_cos"] = 1.0 - float(losses.cosine_similarity_loss(
                outs["normal"].reshape(-1, 3), gt_normal.reshape(-1, 3), weights=dmask.reshape(-1)))
    return row


def load_trainer_run(run_dir: Path, num_views: int, device, step: Optional[int] = None,
                     data_dir: Optional[Path] = None
                     ) -> Tuple[GaussianSplatConfig, ServeState, str, List[Camera], Dict]:
    """A trainer run as the serving route takes it: (model config, state,
    experiment name, the first `num_views` dataset cameras, their ground
    truth, the dataparser scale and transform, and every view's
    `ParsedCamera` under "cameras")."""
    from gaussiangrasper_torch.scripts.common import load_run as load_trainer

    config, trainer, tstate = load_trainer(run_dir, step=step, data_override=data_dir,
                                           device=device)
    fea_up = FeaUp(config.model.feature_dim, config.model.clip_dim)
    fea_up.load_state_dict(tstate.fea_up)
    state = ServeState(tstate.field, tstate.alive, fea_up.to(device), tstate.step)
    dm = trainer.dm
    n = min(num_views, len(dm))
    views = [dm.view_data(i) for i in range(n)]
    data = {k: [v[k] for v in views] for k in GT_KEYS}
    data["dataparser_scale"] = dm.outputs.dataparser_scale
    data["dataparser_transform"] = dm.outputs.dataparser_transform
    data["cameras"] = list(dm.cameras)
    return config.model, state, config.experiment_name, [dm.camera(i) for i in range(n)], data


def trajectory(cameras: List[ParsedCamera], kind: str, num_views: int) -> List[ParsedCamera]:
    """The JAX render tool's paths: 6 steps a transition over every view
    ("interpolate"), or `num_views` frames around view 0 ("spiral")."""
    if kind == "interpolate":
        return interpolate_path(cameras, steps_per_transition=6)
    return spiral_path(cameras[0], n_frames=num_views)


def render_trajectory(state: ServeState, cfg: GaussianSplatConfig, cameras: List[ParsedCamera],
                      kind: str, num_views: int, out_dir: Path, device) -> None:
    """Render each camera of the path and write its rgb as <i>.png."""
    path = trajectory(cameras, kind, num_views)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, pc in enumerate(path):
        cam = Camera.create(pc.fx, pc.fy, pc.cx, pc.cy, pc.camera_to_world, pc.width, pc.height,
                            device=device)
        write_png(out_dir / f"{i:05d}.png", _to_u8(render_view(state, cam, cfg)["rgb"].cpu().numpy()))
    print(f"rendered {len(path)} trajectory frames to {out_dir}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Render eval maps from a trainer or serving run")
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--num-views", type=int, default=16)
    p.add_argument("--step", type=int, default=None, help="trainer run: this checkpoint")
    p.add_argument("--data", type=Path, default=None,
                   help="trainer run: evaluate against this capture instead of the training one")
    p.add_argument("--traj", choices=("dataset", "interpolate", "spiral"), default="dataset",
                   help="dataset views (with metrics) or a camera-path trajectory (rgb only)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    if (args.run_dir / CHECKPOINT).exists():
        cfg, state, name = load_run(args.run_dir, device)
        cams, data = load_cameras(args.run_dir, device)
        data["cameras"] = [ParsedCamera(float(data["fx"][i]), float(data["fy"][i]),
                                        float(data["cx"][i]), float(data["cy"][i]),
                                        int(data["width"]), int(data["height"]), data["c2w"][i])
                           for i in range(len(cams))]
    else:
        cfg, state, name, cams, data = load_trainer_run(args.run_dir, args.num_views, device,
                                                        args.step, args.data)
    out_dir = args.output or (args.run_dir / "renders")
    if args.traj != "dataset":
        render_trajectory(state, cfg, data["cameras"], args.traj, args.num_views,
                          out_dir / "traj", device)
        return
    for sub in ("rgb", "clip", "normal", "depth"):
        (out_dir / sub).mkdir(parents=True, exist_ok=True)
    scale = float(data["dataparser_scale"])
    inv_rot = np.linalg.inv(data["dataparser_transform"][:3, :3])

    results = []
    stats = []
    for i, cam in enumerate(cams[: args.num_views]):
        outs = render_view(state, cam, cfg)
        bins = outs["bins"]
        stats.append({k: int(getattr(bins, k)) for k in ("overflow", "dropped_tiles", "pair_overflow")})
        write_png(out_dir / "rgb" / f"{i:05d}.png", _to_u8(outs["rgb"].cpu().numpy()))
        clip_map = lift(state.fea_up, outs["feature"]).cpu().numpy()
        np.save(out_dir / "clip" / f"{i:05d}_fea.npy", clip_map.astype(np.float16))
        normal = outs["normal"].cpu().numpy() @ inv_rot.T  # back to the capture frame
        np.save(out_dir / "normal" / f"{i:05d}.npy", normal)
        write_png(out_dir / "normal" / f"{i:05d}.png", _to_u8(normal * 0.5 + 0.5))
        depth = outs["depth"][..., 0].cpu().numpy() / scale  # metric
        np.save(out_dir / "depth" / f"{i:05d}.npy", depth)
        write_png(out_dir / "depth" / f"{i:05d}.png", depth2color(depth))
        if "image" in data:
            row = view_metrics(outs, data, i, scale)
            results.append(row)
            print(f"view {i}: psnr={row['psnr']:.2f}")

    summary = {"experiment_name": name, "binning": stats}
    if results:
        summary["results"] = {
            "psnr": float(np.mean([r["psnr"] for r in results])),
            "ssim": float(np.mean([r["ssim"] for r in results])),
            **({"psnr_masked": float(np.mean([r["psnr_masked"] for r in results]))}
               if all("psnr_masked" in r for r in results) else {}),
            **({"lpips": float(np.mean([r["lpips"] for r in results]))}
               if all("lpips" in r for r in results) else {}),
            "per_view": results,
        }
    (out_dir / "metrics.json").write_text(json.dumps(summary, indent=2))
    print(f"rendered {len(stats)} views to {out_dir}")


if __name__ == "__main__":
    main()
