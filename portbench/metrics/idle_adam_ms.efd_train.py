"""Mean ms a traced training step of device idle gaps that begin inside
the program span `train_step/adam` (`optimizers.apply_updates_grouped`:
grouped Adam over seven groups and ten leaves)."""

from harness.spans import idle_ms_per

read = idle_ms_per("train_step/adam", "train_step")
