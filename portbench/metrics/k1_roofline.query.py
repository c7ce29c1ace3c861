"""K1's share (%) of its roofline in the first traced request: the least
time of the ideal front-to-back walk on that request's inputs, counted by
the reference (harness/work.py, `k1_least`), over the device time of that
request's `composite_pairs_fwd_kernel` launch."""

from harness.readers import roofline

read = roofline("composite_pairs_fwd_kernel", "request", "k1")
