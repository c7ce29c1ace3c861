"""The encoder's share (%) of its roofline: its least time at the
published peaks, counted from the configuration's widths
(harness/sam_work.py: linears over the real tokens, windowed attention
over the padded windows), over its device time a request (as
`encoder_ms.sam` reads it)."""

from harness.span_device import roofline_per

read = roofline_per("encoder", "sam/encode", "sam/encode")
