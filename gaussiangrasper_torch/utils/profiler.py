"""Profiling hooks: the port's spans and counters, and a device trace of a
fixed window of training steps (counterpart of the JAX package's
utils/profiler.py).

`PROFILER.section(name)` is the port's span. It is on exactly while a
`torch.profiler` records (torch's own Python flag,
`torch.autograd.profiler._is_profiler_enabled`, is the one test); off, it
hands back one shared null context and calls nothing in torch. On, it opens
a range `ggt::<path>` in the trace, where `path` joins the names of the
spans open on the calling thread with "/" (`train_step/forward/bin`), so
the ranges share the trace's clock with the kernels, and it adds the host
seconds and a call to `totals[path]` / `counts[path]`. A span's self time
is its total less its children's. The ranges are
`torch._C._profiler._RecordFunctionFast` records: the trace files them as
`cpu_op` events beside the aten ops (a `record_function` range would be a
`user_annotation`), and they cost less than `record_function`. A span
given `step` carries it as the range's argument `step`, which the trace
shows when the profile records shapes.

`PROFILER.count(name, value)` adds a host int, or a device scalar (on the
device, no sync), into a counter while spans are on; `counter(name)` reads
it (one sync); `reset()` clears totals, counts and counters. A `Profiler()`
built by hand times every section, traced or not, and `summary()` prints
the JAX package's table.

`TraceCapture` runs `torch.profiler` over steps [start, start + num_steps)
(12..16 by default, the reference's window) with CPU activity, plus CUDA
activity when the trainer's state is on the card, and writes one Chrome
trace JSON into its log directory (`<run_dir>/profiler_traces/` under the
trainer's `profiler="trace"`); the trace holds the `ggt::` spans of those
steps. A trace that cannot start raises; it is never written empty."""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional, Union

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "ggt::"
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("prof", "name", "step", "path", "record", "t0")

    def __init__(self, prof: "Profiler", name: str, step: Optional[int]):
        self.prof, self.name, self.step = prof, name, step

    def __enter__(self) -> "_Span":
        stack = self.prof._stack()
        self.path = stack[-1] + "/" + self.name if stack else self.name
        stack.append(self.path)
        if self.step is None:
            self.record = torch._C._profiler._RecordFunctionFast(PREFIX + self.path)
        else:
            step = int(self.step)
            self.record = torch._C._profiler._RecordFunctionFast(
                PREFIX + self.path, [step], {"step": step})
        self.record.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        dt = time.perf_counter() - self.t0
        self.record.__exit__(*exc)
        self.prof._stack().pop()
        with self.prof._lock:
            self.prof.totals[self.path] += dt
            self.prof.counts[self.path] += 1


class Profiler:
    """Spans and counters; `traced_only` keeps them off unless a
    `torch.profiler` records (the port's `PROFILER`)."""

    def __init__(self, traced_only: bool = False) -> None:
        self.traced_only = traced_only
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, Union[int, torch.Tensor]] = {}
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def on(self) -> bool:
        return _autograd_profiler._is_profiler_enabled or not self.traced_only

    def section(self, name: str, step: Optional[int] = None):
        if not _autograd_profiler._is_profiler_enabled and self.traced_only:
            return _OFF
        return _Span(self, name, step)

    def count(self, name: str, value: Union[int, torch.Tensor]) -> None:
        if not self.on():
            return
        with self._lock:
            acc = self.counters.get(name)
            self.counters[name] = value if acc is None else acc + value

    def counter(self, name: str) -> int:
        return int(self.counters.get(name, 0))

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self.counters.clear()

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


PROFILER = Profiler(traced_only=True)


class TraceCapture:
    """A `torch.profiler` trace of steps [start_step, start_step +
    num_steps), written as `trace_<start>_<stop>.json` (Chrome trace
    format) under `log_dir` when the window closes or at `close()`. Each
    step inside the window is a range named `train_step#<step>`, holding
    the step's `ggt::` spans."""

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
