"""Share (%) of the traced steps' EFD pixel-gather rows that the CUDA
kernels of `csrc/pixel_gather.cu` take: 100 x the program counter
`efd/gather_rows_kernel` over `efd/gather_rows` (N rows a call), both
counted in `ops/pixel_gather.gather_pixels`, which `models/model.train_loss`
calls once a step."""

from harness.spans import keep_share

read = keep_share("efd/gather_rows_kernel", "efd/gather_rows")
