"""Share (%) of the traced steps' hash-grid lookups that the CUDA kernels
of `csrc/hash_grid.cu` take: 100 x the program counter
`hash/lookups_kernel` over `hash/lookups` (N x L (point, level) lookups a
call), both counted in `models/encodings.hash_grid_encode`."""

from harness.spans import keep_share

read = keep_share("hash/lookups_kernel", "hash/lookups")
