"""K2's share (%) of its roofline in the first traced training step: the
least time of the same visits walked in reverse (harness/work.py,
`k2_least`), over the device time of that step's
`composite_pairs_bwd_kernel` launch."""

from harness.readers import roofline

read = roofline("composite_pairs_bwd_kernel", "train_step", "k2")
