"""Mean ms a traced training step of device idle gaps that begin inside
the program span `train_step/forward` or its children (project, bin,
composite, efd): `train_loss` on the host while the device waits."""

from harness.spans import idle_ms_per

read = idle_ms_per("train_step/forward", "train_step")
