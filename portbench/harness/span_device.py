"""Reader bodies for the SAM and grasp cells, on the harness's own
reductions: the device time of a program span is `Trace.seconds_under_op`
on its range `ggt::<path>` (the kernels whose runtime launch lies inside
it, children included), and requests are `spans.steps`. A trace with no
runtime launches (one taken without a card) or a program without the
spans (an older commit) leaves these readers with nothing to read.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from .spans import PREFIX, program_spans, steps


def _device_s(tr, path: str) -> float:
    return tr.seconds_under_op(PREFIX + path)


def device_ms_per(path: str, per: str) -> Callable:
    """Reader: ms of device time launched in `path`, a `per` span."""

    def read(ctx) -> Optional[float]:
        tr = ctx.get("trace")
        n = steps(tr, per) if tr is not None else 0
        t = _device_s(tr, path) if n else 0.0
        return 1e3 * t / n if t > 0 else None

    return read


def device_share(path: str, within: str) -> Callable:
    """Reader: 100 x device time launched in `path` over that in `within`."""

    def read(ctx) -> Optional[float]:
        tr = ctx.get("trace")
        total = _device_s(tr, within) if tr is not None else 0.0
        return 100.0 * _device_s(tr, path) / total if total > 0 else None

    return read


def host_ms_per(paths: Sequence[str], per: str) -> Callable:
    """Reader: ms the host spent in spans `paths` begun inside the traced
    stretch, a `per` span."""

    def read(ctx) -> Optional[float]:
        tr = ctx.get("trace")
        n = steps(tr, per) if tr is not None else 0
        if not n:
            return None
        return 1e-3 * sum(b - a for a, b, p, _ in program_spans(tr)
                          if p in paths and tr.t0 <= a <= tr.t1) / n

    return read


def roofline_per(work: str, path: str, per: str) -> Callable:
    """Reader: 100 x the least time `ctx["work"][work]` over the device
    time launched in `path`, a `per` span."""
    device_ms = device_ms_per(path, per)

    def read(ctx) -> Optional[float]:
        w, ms = ctx.get("work"), device_ms(ctx)
        return 1e5 * w[work]["least_s"] / ms if w and ms else None

    return read
