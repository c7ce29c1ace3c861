"""Share (%) of the traced steps' device time in the kernels launched by
the autograd node `IndexBackward0`: the backward of the hash tables'
gather `table[rows]` (models/encodings.py, the field's and the proposal
grids'), the step's one advanced-index read of a tensor that takes a
gradient; on the card index_put's sort and `indexing_backward_kernel`."""

from harness.readers import index_backward_share as read  # noqa: F401
