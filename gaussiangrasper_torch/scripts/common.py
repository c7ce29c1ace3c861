"""Loading a trainer run for the offline tools (counterpart of the JAX
package's scripts/common.py).

A trainer run is <run>/config.json plus <run>/checkpoints/step_*.pt. The
config loads whichever package wrote it (the two TrainerConfigs have the
same fields); the cameras and ground truth are rebuilt from the data dir it
names, as the JAX package's `load_run` does.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple

from gaussiangrasper_torch.engine import checkpoint as ckpt
from gaussiangrasper_torch.engine.train_state import TrainState
from gaussiangrasper_torch.engine.trainer import Trainer, TrainerConfig, make_trainer
from gaussiangrasper_torch.models.model import GaussianSplatConfig


def config_from_json(path: Path) -> TrainerConfig:
    payload = json.loads(Path(path).read_text())
    model = GaussianSplatConfig.from_dict(payload.pop("model"))
    for k in ("data", "output_dir", "load_dir"):
        if payload.get(k) is not None:
            payload[k] = Path(payload[k])
    return TrainerConfig(model=model, **payload)


def load_run(run_dir: Path, step: Optional[int] = None, data_override: Optional[Path] = None,
             device=None) -> Tuple[TrainerConfig, Trainer, TrainState]:
    """(config, trainer with its datamanager on `device`, the state of the
    checkpoint at `step`, default the latest)."""
    run_dir = Path(run_dir)
    config = config_from_json(run_dir / "config.json")
    if data_override is not None:
        config.data = Path(data_override)
    trainer = make_trainer(config, device=device)
    path = (run_dir / "checkpoints" / ckpt.STEP_FMT.format(step) if step is not None
            else ckpt.latest_checkpoint(run_dir / "checkpoints"))
    if path is None or not Path(path).exists():
        raise FileNotFoundError(f"no checkpoint under {run_dir / 'checkpoints'}")
    trainer.state = ckpt.load_checkpoint(path, trainer.device)
    return config, trainer, trainer.state
