"""Spans from the benchmark's own files and the reduction of a device
trace to the numbers the per-layer readers take.

Spans are `torch.profiler.record_function` annotations named
`bench::<layer>` around the calls into each layer, so they share the
trace's clock with the kernels. A traced run profiles a short stretch of
its window (`Profile`), exports the Chrome trace into TMPDIR, and
`reduce` turns it into: the window's length, the union of kernel
intervals within it (device busy seconds: overlapping kernels count once),
device time by kernel name, the idle gaps labelled by the innermost
benchmark span open when each began, and the kernels launched from inside
a given CPU op (an autograd node, say).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from bisect import bisect_right
from collections import defaultdict
from pathlib import Path
from typing import Callable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op",)
"""What stands for the device's work in a trace taken without a card (the
CPU tests drive the same reduction)."""
WINDOW = "bench::window"


class Spans:
    """`span(name)` opens bench::<name> in a traced run and nothing otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function("bench::" + name)

    def wrap(self, fn: Callable, name: str) -> Callable:
        if not self.on:
            return fn

        def wrapped(*a, **k):
            with self.span(name):
                return fn(*a, **k)

        return wrapped


class SyncTimer:
    """Host seconds of calls that begin and end with a synchronize: a
    layer's own time, for traced runs only (the syncs change the loop)."""

    def __init__(self):
        self.seconds: List[float] = []

    def wrap(self, fn: Callable) -> Callable:
        from .common import sync

        def timed(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            self.seconds.append(time.perf_counter() - t0)
            return out

        return timed


class Profile:
    """torch.profiler over CPU and CUDA, started and stopped by the driver
    around a stretch of its window, which sits inside bench::window."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self.prof = profile(activities=acts)
        self._window = None
        self.stopped = False
        self.trace = None

    def start(self) -> None:
        from .common import sync

        sync()
        self.prof.start()
        self._window = self._torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> None:
        from .common import sync

        sync()
        self._window.__exit__(None, None, None)
        self.prof.stop()
        self.stopped = True

    def reduce(self) -> "Trace":
        """Export the Chrome trace into TMPDIR and reduce it; after the
        window, since the export takes seconds."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.trace = reduce(Path(path), DEVICE_CATS if self._torch.cuda.is_available()
                                else HOST_CATS)
        finally:
            os.unlink(path)
        return self.trace


def warm_profiler() -> None:
    """Start and stop one profile in set-up: the first start initializes
    CUPTI, which takes seconds that must not fall in the window."""
    import torch

    p = Profile()
    p.start()
    torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
    p.stop()


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Trace:
    """What a Chrome trace holds for the benchmark; times in microseconds."""

    def __init__(self, events: List[dict], device_cats=DEVICE_CATS):
        wins = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if not wins:
            raise ValueError("the trace holds no bench::window span")
        w = wins[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.kernels = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"],
                         (e.get("args") or {}).get("correlation"))
                        for e in events if e.get("cat") in device_cats and e.get("ph") == "X"]
        self.kernels.sort()
        self.spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len("bench::"):])
                      for e in events if e.get("cat") == "user_annotation"
                      and e.get("name", "").startswith("bench::") and e["name"] != WINDOW]
        self.cpu_ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"], e.get("tid"))
                        for e in events if e.get("cat") == "cpu_op" and e.get("ph") == "X"]
        self.launches = [(float(e["ts"]), e.get("tid"), (e.get("args") or {}).get("correlation"))
                         for e in events if e.get("cat") == "cuda_runtime" and e.get("ph") == "X"]
        inside = [(max(a, self.t0), min(b, self.t1)) for a, b, _, _ in self.kernels
                  if b > self.t0 and a < self.t1]
        self.busy = _merge(inside)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def in_window(self):
        return [k for k in self.kernels if k[0] >= self.t0 and k[1] <= self.t1]

    def device_ops(self, top: int = 10) -> List[list]:
        by = defaultdict(float)
        for a, b, name, _ in self.in_window():
            by[name[:120]] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda r: -r[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle device time in the window summed by the benchmark span
        that was innermost-open on the host when each gap began ("none"
        outside every span)."""
        edges, prev = [], self.t0
        for a, b in self.busy:
            if a > prev:
                edges.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            edges.append((prev, self.t1))
        by = defaultdict(float)
        for a, b in edges:
            open_ = [s for s in self.spans if s[0] <= a < s[1]]
            label = min(open_, key=lambda s: s[1] - s[0])[2] if open_ else "none"
            by[label] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda r: -r[1])[:top]]

    def kernel_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(b - a for a, b, n, _ in self.in_window() if match(n)) * 1e-6

    def first_kernel_after_span(self, span: str, match: Callable[[str], bool]) -> Optional[float]:
        """Seconds of the first kernel matching `match` that starts after the
        first `span` of the window begins: on one in-order stream, that
        span's own launch (the kernels of a ctypes library may carry no
        runtime correlation, so the order is what ties them)."""
        spans = sorted(s for s in self.spans if s[2] == span and s[0] >= self.t0)
        if not spans:
            return None
        a = spans[0][0]
        for ka, kb, name, _ in self.in_window():
            if ka >= a and match(name):
                return (kb - ka) * 1e-6
        return None

    def seconds_under_op(self, op_substring: str) -> float:
        """Device seconds of the window's kernels launched from inside a CPU
        op whose name holds `op_substring` (on the op's own thread)."""
        ops = defaultdict(list)
        for a, b, name, tid in self.cpu_ops:
            if op_substring in name:
                ops[tid].append((a, b))
        merged = {tid: _merge(v) for tid, v in ops.items()}
        starts = {tid: [a for a, _ in v] for tid, v in merged.items()}
        corr = set()
        for ts, tid, c in self.launches:
            if tid in merged and c is not None:
                i = bisect_right(starts[tid], ts) - 1
                if i >= 0 and ts <= merged[tid][i][1]:
                    corr.add(c)
        return sum(b - a for a, b, _, c in self.in_window() if c in corr) * 1e-6


def reduce(path: Path, device_cats=DEVICE_CATS) -> Trace:
    events = json.loads(Path(path).read_text())
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return Trace(events, device_cats)
