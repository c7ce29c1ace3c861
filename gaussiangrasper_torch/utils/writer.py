"""Metrics fan-out: terminal dashboard + optional TensorBoard/wandb/comet
(a copy of the JAX package's utils/writer.py).

Scalars and images go to the chosen backends, plus a rate counter giving
pixels/s (nerfstudio's TRAIN_RAYS_PER_SEC). A backend whose library is not
importable degrades with a one-line notice, as nerfstudio registers only
writers whose libraries import.
"""

from __future__ import annotations

import time
from collections import deque
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np


class _TensorboardBackend:
    def __init__(self, log_dir: Path):
        from torch.utils.tensorboard import SummaryWriter

        self._tb = SummaryWriter(log_dir=str(log_dir))

    def scalar(self, tag, value, step):
        self._tb.add_scalar(tag, value, step)

    def image(self, tag, img, step):
        self._tb.add_image(tag, img, step, dataformats="HWC")

    def close(self):
        self._tb.close()


class _WandbBackend:
    """Weights & Biases backend. Constructed
    only if `wandb` imports; `init` mirrors nerfstudio's
    project/name/dir wiring."""

    def __init__(self, log_dir: Path, experiment_name: str, project: str):
        import wandb  # noqa: F401 — optional dependency

        self._wandb = wandb
        self._run = wandb.init(
            project=project, name=experiment_name, dir=str(log_dir),
            reinit=True,
        )

    def scalar(self, tag, value, step):
        self._wandb.log({tag: value}, step=step)

    def image(self, tag, img, step):
        self._wandb.log({tag: self._wandb.Image(np.asarray(img))}, step=step)

    def close(self):
        self._run.finish()


class _CometBackend:
    """Comet backend."""

    def __init__(self, log_dir: Path, experiment_name: str, project: str):
        import comet_ml

        self._exp = comet_ml.Experiment(project_name=project)
        self._exp.set_name(experiment_name)

    def scalar(self, tag, value, step):
        self._exp.log_metric(tag, value, step=step)

    def image(self, tag, img, step):
        self._exp.log_image(np.asarray(img), name=tag, step=step)

    def close(self):
        self._exp.end()


def _make_backends(
    vis: Sequence[str],
    log_dir: Optional[Path],
    experiment_name: str,
    project: str,
):
    """Instantiate the requested backends, dropping any whose library is
    missing (with a one-line notice, like nerfstudio's writer setup)."""
    backends = []
    for name in vis:
        try:
            if name == "tensorboard" and log_dir is not None:
                backends.append(_TensorboardBackend(log_dir))
            elif name == "wandb":
                backends.append(_WandbBackend(log_dir or Path("."),
                                              experiment_name, project))
            elif name == "comet":
                backends.append(_CometBackend(log_dir or Path("."),
                                              experiment_name, project))
        except Exception as e:  # missing package, offline init failure, ...
            print(f"metrics backend {name!r} unavailable ({e}); skipping")
    return backends


class MetricsWriter:
    def __init__(
        self,
        log_dir: Optional[Path] = None,
        tensorboard: bool = False,
        steps_per_log: int = 10,
        max_steps: int = 30000,
        vis: Sequence[str] = (),
        experiment_name: str = "gaussiangrasper-torch",
        project: str = "gaussiangrasper-torch",
    ):
        self.steps_per_log = steps_per_log
        self.max_steps = max_steps
        names = list(vis)
        if tensorboard and "tensorboard" not in names:
            names.append("tensorboard")
        self._backends = _make_backends(names, log_dir, experiment_name, project)
        self._times = deque(maxlen=20)
        self._last = time.perf_counter()

    @property
    def has_backend(self) -> bool:
        return bool(self._backends)

    def step(self, step: int, metrics: Dict[str, float], pixels: int = 0) -> None:
        now = time.perf_counter()
        self._times.append(now - self._last)
        self._last = now
        for b in self._backends:
            for k, v in metrics.items():
                b.scalar(f"train/{k}", float(v), step)
        if step % self.steps_per_log == 0:
            it_s = np.mean(self._times) if self._times else 0.0
            px_s = pixels / it_s if it_s > 0 else 0.0
            eta = (self.max_steps - step) * it_s
            parts = " ".join(
                f"{k}={float(v):.4g}" for k, v in metrics.items() if np.isscalar(v)
                or getattr(v, "ndim", 1) == 0
            )
            print(
                f"[{step:6d}/{self.max_steps}] {parts} "
                f"| {it_s * 1e3:.0f} ms/it {px_s / 1e6:.2f} Mpx/s eta {eta / 60:.1f}m",
                flush=True,
            )

    def image(self, step: int, tag: str, img: np.ndarray) -> None:
        for b in self._backends:
            b.image(tag, img, step)

    def close(self) -> None:
        for b in self._backends:
            b.close()
