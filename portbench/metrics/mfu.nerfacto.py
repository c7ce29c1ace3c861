"""The whole nerfacto step's share (%) of the card's published peaks: the
least time of its work (harness/work.py, `nerfacto_step_least`: the hash
lookups and MLPs of every sample of every level forward and back, the
distortion loss, the tables read once, Adam over every parameter) over the
window's measured time a step."""

from harness.readers import mfu

read = mfu("step", "step", "step_s")
