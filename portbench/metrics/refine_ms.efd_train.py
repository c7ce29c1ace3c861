"""Mean ms of a window refine, `train_state.refine_step` between two
synchronizations: traced runs only, on the refines outside the profiled
stretch (the syncs would change the stretch's loop)."""

from harness.readers import mean_ms

read = mean_ms("refine_s")
