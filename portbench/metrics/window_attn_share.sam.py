"""Share (%) of the encoder's device time launched inside its windowed
attention blocks (`sam/encode/window_attn`: LayerNorm, the window
partition with its padding, the attention, the unpartition and the
residual add) over the traced stretch."""

from harness.span_device import device_share

read = device_share("sam/encode/window_attn", "sam/encode")
