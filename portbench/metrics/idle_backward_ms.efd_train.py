"""Mean ms a traced training step of device idle gaps that begin inside
the program span `train_step/backward` (`torch.autograd.grad`; the
compositor backward `composite_bwd` runs on autograd's device thread, while
the calling thread waits inside this span)."""

from harness.spans import idle_ms_per

read = idle_ms_per("train_step/backward", "train_step")
