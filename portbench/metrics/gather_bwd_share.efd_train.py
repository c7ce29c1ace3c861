"""Share (%) of the traced steps' device time in the kernels launched by
the autograd node `IndexBackward0`: the backward of train_loss's fused
pixel gather `fea[idx[:, 0], idx[:, 1]]` (models/model.py), the step's one
advanced-index read of a tensor that takes a gradient; on the card its
kernels are index_put's sort and `indexing_backward_kernel`."""

from harness.readers import index_backward_share as read  # noqa: F401
