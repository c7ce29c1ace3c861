"""nerfstudio's train rays/s of the splat trainer: the supervised pixels
(H x W a step) of every step completed in the window over the window's
time, on the host clock (the end after a synchronize). In a traced run
the window holds the profiled stretch."""

from harness.readers import value

read = value("rays_per_s")
