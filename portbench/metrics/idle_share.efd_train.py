"""Idle share (%) of the device over the traced stretch of the window:
100 x (1 - the union of kernel intervals / the stretch's length), so
overlapping kernels count once."""

from harness.readers import idle_share as read  # noqa: F401
