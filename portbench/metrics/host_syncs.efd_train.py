"""Host syncs a traced training step: device-to-host copies launched
inside any program span (the step's and the trainer loop's: loss_check,
log, refine, ...), over the traced `train_step` spans."""

from harness.spans import syncs_per

read = syncs_per("train_step")
