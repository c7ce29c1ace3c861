"""The whole training step's share (%) of the card's published peaks: the
least time of the work the step's inputs need (harness/work.py,
`splat_step_least`: projection, SH, K1 and K2 on the reference's walk of
the traced step, the losses, the feature terms, Adam over the live rows,
the refine amortized) over the window's measured time a step."""

from harness.readers import mfu

read = mfu("step", "step", "step_s")
