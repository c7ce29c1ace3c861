"""The program's own spans in a reduced trace, and the bodies of the
per-layer readers that take them.

The port opens each span as a range `ggt::<path>` (gaussiangrasper_torch/
utils/profiler.py), where `path` joins the names of the spans open on the
calling thread with "/" (`train_step/forward/bin`). The trace files those
ranges as `cpu_op` events, so `Trace.cpu_ops` holds them with their thread.
A program without them (an older commit) leaves every reader here with
nothing to read.

A gap "in X" is an idle interval of the device inside the traced stretch
that begins while a span X, or one of its children, is open on any thread.
A host sync is a device-to-host copy (`Memcpy DtoH`) launched inside a
span, on the span's thread: each read of device memory by the host, which
the host waits for (`.item()`, `float()`, `bool()`, `.cpu()`, `nonzero`).
Steps and requests are counted from the spans `train_step`, `nerf_step`
and `render_view` that begin in the stretch.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, List, Optional, Tuple

PREFIX = "ggt::"


def program_spans(tr) -> List[Tuple[float, float, str, object]]:
    """(start, end, path, thread) of every program span in the trace."""
    return [(a, b, name[len(PREFIX):], tid) for a, b, name, tid in tr.cpu_ops
            if name.startswith(PREFIX)]


def _under(path: str, root: str) -> bool:
    return not root or path == root or path.startswith(root + "/")


def _gaps(tr) -> List[Tuple[float, float]]:
    """The stretch's idle intervals of the device, as `Trace.idle_gaps`
    cuts them."""
    edges, prev = [], tr.t0
    for a, b in tr.busy:
        if a > prev:
            edges.append((prev, a))
        prev = max(prev, b)
    if tr.t1 > prev:
        edges.append((prev, tr.t1))
    return edges


def idle_within(tr, root: str) -> float:
    """Seconds of the stretch's idle gaps that begin inside a span `root`
    or one of its children, on any thread."""
    spans = [(a, b) for a, b, path, _ in program_spans(tr) if _under(path, root)]
    return 1e-6 * sum(b - a for a, b in _gaps(tr)
                      if any(sa <= a < sb for sa, sb in spans))


def syncs_within(tr, root: str = "") -> int:
    """Device-to-host copies of the stretch launched inside a span `root`
    or one of its children (any span with `root` ""), on its thread."""
    dtoh = {corr for a, _, name, corr in tr.in_window() if "DtoH" in name and corr is not None}
    by_tid = defaultdict(list)
    for a, b, path, tid in program_spans(tr):
        if _under(path, root):
            by_tid[tid].append((a, b))
    return sum(1 for ts, tid, corr in tr.launches
               if corr in dtoh and any(a <= ts <= b for a, b in by_tid.get(tid, ())))


def steps(tr, name: str) -> int:
    """Spans `name` (top-level) that begin inside the stretch."""
    return sum(1 for a, _, path, _ in program_spans(tr) if path == name and tr.t0 <= a <= tr.t1)


def idle_ms_per(root: str, per: str) -> Callable:
    """Reader: ms of idle gaps in `root` a `per` span."""

    def read(ctx) -> Optional[float]:
        tr = ctx.get("trace")
        n = steps(tr, per) if tr is not None else 0
        return 1e3 * idle_within(tr, root) / n if n else None

    return read


def syncs_per(per: str) -> Callable:
    """Reader: host syncs inside any program span, a `per` span."""

    def read(ctx) -> Optional[float]:
        tr = ctx.get("trace")
        n = steps(tr, per) if tr is not None else 0
        return syncs_within(tr) / n if n else None

    return read


def keep_share(kept: str, attempted: str) -> Callable:
    """Reader: 100 x the program counter `kept` over `attempted`, as the
    port's `PROFILER` holds them after a traced run (counted only while
    the profiler records)."""

    def read(ctx) -> Optional[float]:
        if ctx.get("trace") is None:
            return None
        from gaussiangrasper_torch.utils import profiler

        if not hasattr(profiler.PROFILER, "counter"):
            return None
        total = profiler.PROFILER.counter(attempted)
        return 100.0 * profiler.PROFILER.counter(kept) / total if total else None

    return read
