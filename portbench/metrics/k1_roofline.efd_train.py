"""K1's share (%) of its roofline in the first traced training step: the
least time of the ideal front-to-back walk on that step's inputs, counted
by the reference (harness/work.py, `k1_least`), over the device time of
that step's `composite_pairs_fwd_kernel` launch."""

from harness.readers import roofline

read = roofline("composite_pairs_fwd_kernel", "train_step", "k1")
