"""Mean ms a traced request of device idle gaps that begin inside the
program span `render_view/bin` (`ops/rasterize.bin_gaussians`: the
pair enumeration, the sort and the segment bounds)."""

from harness.spans import idle_ms_per

read = idle_ms_per("render_view/bin", "render_view")
