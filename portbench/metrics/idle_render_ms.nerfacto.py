"""Mean ms a traced nerfacto step of device idle gaps that begin inside
the program span `nerf_step/render` (`render_rays` and the loss)."""

from harness.spans import idle_ms_per

read = idle_ms_per("nerf_step/render", "nerf_step")
