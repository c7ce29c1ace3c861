"""Host syncs a traced nerfacto step: device-to-host copies launched
inside any program span (the step's, and `history`, the loop's `float()` of
each metric), over the traced `nerf_step` spans."""

from harness.spans import syncs_per

read = syncs_per("nerf_step")
