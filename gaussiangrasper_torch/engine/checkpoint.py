"""The port's serving run directory, and training checkpoints.

    <run>/checkpoint.pt  one torch.save file: field, alive, fea_up state,
                         step, model config, experiment name
    <run>/cameras.npz    the views to render: fx, fy, cx, cy (V,), c2w
                         (V, 3, 4) OpenGL, width, height, dataparser_scale,
                         dataparser_transform (3, 4); optional ground truth
                         image (V, H, W, 3), depth (V, H, W), normal
                         (V, H, W, 3), valid_mask (V, H, W)

`cameras.npz` stands in for the capture until the port has its data layer.
Orbax runs of the JAX package cannot be read here (that needs JAX);
convert them through `weights.state_from_numpy` (serving) or
`weights.train_state_from_numpy` (training) in a process that has both.

A training checkpoint is one torch.save file `<dir>/step_{:09d}.pt` holding
the whole `TrainState`: step, field, alive, fea_up, the camera pose deltas
(when pose optimization is on), every optimizer group's moments, count and
accumulator ("camera_opt" among them), the densify stats and the state of
the split-noise generator (reseeded from its seed when the checkpoint is
loaded on the other device type). A checkpoint without pose deltas loads
with `pose` None.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gaussiangrasper_torch.core.cameras import Camera
from gaussiangrasper_torch.engine import optimizers as optim
from gaussiangrasper_torch.engine.refinement import DensifyStats
from gaussiangrasper_torch.engine.train_state import TrainState
from gaussiangrasper_torch.engine.weights import ServeState
from gaussiangrasper_torch.models.efd import FeaUp
from gaussiangrasper_torch.models.gaussian_field import FIELD_KEYS, GaussianParams
from gaussiangrasper_torch.models.model import GaussianSplatConfig

CHECKPOINT = "checkpoint.pt"
CAMERAS = "cameras.npz"
GT_KEYS = ("image", "depth", "normal", "valid_mask")
STEP_FMT = "step_{:09d}.pt"


def save_run(run_dir: Path, state: ServeState, cfg: GaussianSplatConfig,
             experiment_name: str = "") -> Path:
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    path = run_dir / CHECKPOINT
    torch.save({
        "field": {k: v.detach().cpu() for k, v in zip(FIELD_KEYS, state.field)},
        "alive": state.alive.cpu(),
        "fea_up": {k: v.cpu() for k, v in state.fea_up.state_dict().items()},
        "fea_up_dims": [state.fea_up.layers[0].in_features]
                       + [layer.out_features for layer in state.fea_up.layers],
        "step": int(state.step),
        "model_config": dataclasses.asdict(cfg),
        "experiment_name": experiment_name or run_dir.name,
    }, path)
    return path


def load_run(run_dir: Path, device=None) -> Tuple[GaussianSplatConfig, ServeState, str]:
    """(model config, state on `device`, experiment name)."""
    payload = torch.load(Path(run_dir) / CHECKPOINT, map_location="cpu", weights_only=True)
    dims = payload["fea_up_dims"]
    fea_up = FeaUp(dims[0], dims[-1], dims[1:-1])
    fea_up.load_state_dict(payload["fea_up"])
    state = ServeState(
        field=GaussianParams(*(payload["field"][k] for k in FIELD_KEYS)),
        alive=payload["alive"], fea_up=fea_up, step=int(payload["step"]),
    )
    cfg = GaussianSplatConfig.from_dict(payload["model_config"])
    return cfg, state.to(device), payload["experiment_name"]


def save_cameras(run_dir: Path, fx, fy, cx, cy, c2w, width: int, height: int,
                 dataparser_scale: float = 1.0, dataparser_transform=None,
                 **gt: np.ndarray) -> Path:
    unknown = set(gt) - set(GT_KEYS)
    if unknown:
        raise ValueError(f"unknown ground-truth keys {sorted(unknown)}; expected {GT_KEYS}")
    if dataparser_transform is None:
        dataparser_transform = np.eye(4, dtype=np.float32)[:3]
    path = Path(run_dir) / CAMERAS
    np.savez(path, fx=np.asarray(fx, np.float32), fy=np.asarray(fy, np.float32),
             cx=np.asarray(cx, np.float32), cy=np.asarray(cy, np.float32),
             c2w=np.asarray(c2w, np.float32), width=int(width), height=int(height),
             dataparser_scale=float(dataparser_scale),
             dataparser_transform=np.asarray(dataparser_transform, np.float32), **gt)
    return path


def load_cameras(run_dir: Path, device=None) -> Tuple[List[Camera], Dict[str, np.ndarray]]:
    """(one Camera per view on `device`, the rest of cameras.npz as numpy)."""
    with np.load(Path(run_dir) / CAMERAS) as z:
        data = {k: z[k] for k in z.files}
    cams = [Camera.create(data["fx"][i], data["fy"][i], data["cx"][i], data["cy"][i],
                          data["c2w"][i], int(data["width"]), int(data["height"]), device=device)
            for i in range(data["c2w"].shape[0])]
    return cams, data


def _cpu(tree):
    return optim.tree_map(lambda x: x.detach().cpu(), tree)


def save_checkpoint(ckpt_dir: Path, state: TrainState, step: Optional[int] = None,
                    keep_only_latest: bool = True) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    step = state.step if step is None else step
    path = (ckpt_dir / STEP_FMT.format(step)).absolute()
    torch.save({
        "step": state.step,
        "field": {k: v.detach().cpu() for k, v in zip(FIELD_KEYS, state.field)},
        "alive": state.alive.cpu(),
        "fea_up": _cpu(state.fea_up),
        "opt": {name: {"mu": _cpu(st.mu), "nu": _cpu(st.nu), "count": st.count.cpu(),
                       "accum": _cpu(st.accum)} for name, st in state.opt.items()},
        "stats": {k: v.cpu() for k, v in zip(DensifyStats._fields, state.stats)},
        "generator": state.generator.get_state(),
        "pose": None if state.pose is None else state.pose.detach().cpu(),
    }, path)
    if keep_only_latest:
        for p in ckpt_dir.glob("step_*.pt"):
            if p.absolute() != path:
                p.unlink()
    return path


def latest_checkpoint(ckpt_dir: Path) -> Optional[Path]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(ckpt_dir.glob("step_*.pt"))
    return steps[-1].absolute() if steps else None


def load_checkpoint(path: Path, device=None) -> TrainState:
    """The `TrainState` saved at `path`, on `device` (default cpu)."""
    payload = torch.load(Path(path), map_location="cpu", weights_only=True)
    dev = torch.device(device or "cpu")
    to = lambda tree: optim.tree_map(lambda x: x.to(dev), tree)  # noqa: E731
    generator = torch.Generator(device=dev)
    saved = payload["generator"]
    if saved.numel() == generator.get_state().numel():
        generator.set_state(saved)
    else:
        # saved on the other device type (CPU mt19937 / CUDA Philox states
        # differ): both states begin with the seed, and the two draw
        # different streams anyway, so the stream restarts from that seed
        generator.manual_seed(int.from_bytes(bytes(saved[:8].tolist()), "little"))
    return TrainState(
        step=int(payload["step"]),
        field=GaussianParams(*(payload["field"][k].to(dev) for k in FIELD_KEYS)),
        alive=payload["alive"].to(dev),
        fea_up=to(payload["fea_up"]),
        opt={name: optim.GroupOptState(to(st["mu"]), to(st["nu"]), st["count"].to(dev),
                                       to(st["accum"])) for name, st in payload["opt"].items()},
        stats=DensifyStats(*(payload["stats"][k].to(dev) for k in DensifyStats._fields)),
        generator=generator,
        pose=None if payload.get("pose") is None else payload["pose"].to(dev),
    )
