"""The bodies the per-layer metric files share. Each file under metrics/
names its metric and what it reads, and binds `read` to one of these (with
its own arguments); `read(ctx)` returns a number, or None where the run
holds nothing to read."""

from __future__ import annotations

import statistics
from typing import Callable, Optional


def idle_share(ctx) -> Optional[float]:
    """Idle share (%) of the device over the traced stretch: 100 x (1 - the
    union of kernel intervals / the stretch's length)."""
    tr = ctx.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def index_backward_share(ctx) -> Optional[float]:
    """Share (%) of the traced stretch's kernel time launched from inside
    the autograd node `IndexBackward0`."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    total = tr.kernel_seconds(lambda name: True)
    return 100.0 * tr.seconds_under_op("IndexBackward0") / total if total > 0 else None


def roofline(kernel: str, span: str, work: str) -> Callable:
    """A kernel's share (%) of its roofline: the least time of `ctx["work"][work]`
    over the device time of the first `kernel` launch in the first traced
    `span`."""

    def read(ctx) -> Optional[float]:
        w, tr = ctx.get("work"), ctx.get("trace")
        if not w or tr is None:
            return None
        t = tr.first_kernel_after_span(span, lambda name: kernel in name)
        return 100.0 * w[work]["least_s"] / t if t else None

    return read


def mfu(work: str, part: str, time_key: str) -> Callable:
    """The whole step's or request's share (%) of the card's published
    peaks: the least time `ctx["work"][work][part]` over the measured
    seconds `ctx[time_key]`."""

    def read(ctx) -> Optional[float]:
        w, t = ctx.get("work"), ctx.get(time_key) or 0.0
        if not w or t <= 0:
            return None
        return 100.0 * w[work][part] / t

    return read


def mean_ms(key: str) -> Callable:
    def read(ctx) -> Optional[float]:
        s = ctx.get(key) or []
        return 1e3 * sum(s) / len(s) if s else None

    return read


def median_ms(key: str) -> Callable:
    def read(ctx) -> Optional[float]:
        s = ctx.get(key) or []
        return 1e3 * statistics.median(s) if s else None

    return read


def value(key: str) -> Callable:
    def read(ctx) -> Optional[float]:
        return ctx.get(key)

    return read
