"""Share (%) of the binning sort's keys that are kept pairs, over the
traced stretch: 100 x the program counter `bin/pairs_kept` (each
Gaussian's covered tiles that survive the cap and the alpha pruning, summed
on the device) over `bin/pairs_sorted` (N x MT keys a sort takes, dead
capacity rows included), both counted in `ops/rasterize.bin_gaussians`."""

from harness.spans import keep_share

read = keep_share("bin/pairs_kept", "bin/pairs_sorted")
