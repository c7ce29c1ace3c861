"""Profiling hooks: a wall-time profiler of tagged host sections and a
device trace of a fixed window of training steps (counterpart of the JAX
package's utils/profiler.py).

`Profiler` / `PROFILER` total the host seconds of each `section` and print
the same table as the JAX one. `TraceCapture` runs `torch.profiler` over
steps [start, start + num_steps) (12..16 by default, the reference's
window) with CPU activity, plus CUDA activity when the trainer's state is
on the card, and writes one Chrome trace JSON into its log directory
(`<run_dir>/profiler_traces/` under the trainer's `profiler="trace"`).
A trace that cannot start raises; it is never written empty."""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

import torch


class Profiler:
    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def time_function(self, fn, name: Optional[str] = None):
        tag = name or fn.__qualname__

        def wrapped(*a, **kw):
            with self.section(tag):
                return fn(*a, **kw)

        return wrapped

    def summary(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        lines = [f"{'section':<40} {'total s':>10} {'calls':>8} {'ms/call':>10}"]
        for name, tot in rows:
            n = self.counts[name]
            lines.append(f"{name:<40} {tot:>10.2f} {n:>8d} {tot / n * 1e3:>10.2f}")
        return "\n".join(lines)

    def flush(self) -> None:
        if self.totals:
            print(self.summary(), flush=True)


PROFILER = Profiler()


class TraceCapture:
    """A `torch.profiler` trace of steps [start_step, start_step +
    num_steps), written as `trace_<start>_<stop>.json` (Chrome trace
    format) under `log_dir` when the window closes or at `close()`. Each
    step inside the window is a range named `train_step#<step>`."""

    def __init__(self, log_dir: Path, start_step: int = 12, num_steps: int = 5,
                 device: Optional[torch.device] = None):
        self.log_dir = Path(log_dir)
        self.start = start_step
        self.stop = start_step + num_steps
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.path: Optional[Path] = None
        self._prof = None
        self._range = None

    def maybe_step(self, step: int) -> None:
        if step == self.start and self._prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                torch.cuda.synchronize()
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
        elif step == self.stop and self._prof is not None:
            self._finish()
            print(f"profiler trace written to {self.path}", flush=True)
        if self._prof is not None:
            self._close_range()
            self._range = torch.profiler.record_function(f"train_step#{step}")
            self._range.__enter__()

    def _close_range(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None

    def _finish(self) -> None:
        self._close_range()
        if self.cuda:
            torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        path = self.log_dir / f"trace_{self.start}_{self.stop}.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
        missing = None
        if not any(e.get("ph") == "X" for e in events):
            missing = "no event for the traced steps"
        elif self.cuda and not any(e.get("cat") == "kernel" for e in events):
            missing = "no kernel on the card (CUPTI did not start)"
        if missing:
            path.unlink()
            raise RuntimeError(f"torch.profiler recorded {missing}")
        self.path = path

    def close(self) -> None:
        """Stop and write a trace whose window is still open."""
        if self._prof is not None:
            self._finish()
