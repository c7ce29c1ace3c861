"""Share (%) of the encoder's device time launched inside its global
attention blocks (`sam/encode/global_attn`: LayerNorm, the attention over
every token and the residual add) over the traced stretch."""

from harness.span_device import device_share

read = device_share("sam/encode/global_attn", "sam/encode")
