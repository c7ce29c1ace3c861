"""The stand-in a driver puts in place of the program's step function (a
module attribute the loop looks up each step): it ends the loop once
`limit` steps ran or the `deadline` passed (`StopWindow`, which the loop's
own `finally` survives), passes the step's arguments through `feed` where
a fault alters what the loop produced, runs `body` (the step itself, or
the step with a fault planted) inside the step's span, and hands each
finished step, with the arguments it was fed, to `on_step`."""

from __future__ import annotations

import time
from typing import Callable, Optional

from .common import StopWindow
from .trace import Spans


class Gate:
    def __init__(self, step_fn: Callable, spans: Spans, span: str):
        self.step_fn = step_fn
        self.body = step_fn
        self.spans = spans
        self.span = span
        self.limit: Optional[int] = None
        self.deadline: Optional[float] = None
        self.done = 0
        self.feed: Optional[Callable] = None
        self.before_step: Optional[Callable] = None
        self.on_step: Optional[Callable] = None

    def __call__(self, *args, **kw):
        if (self.limit is not None and self.done >= self.limit) or \
                (self.deadline is not None and time.perf_counter() >= self.deadline):
            raise StopWindow
        if self.feed is not None:
            args = self.feed(args)
        if self.before_step is not None:
            self.before_step(self.done, args)
        with self.spans.span(self.span):
            out = self.body(*args, **kw)
        self.done += 1
        if self.on_step is not None:
            self.on_step(self.done, args, out)
        return out
