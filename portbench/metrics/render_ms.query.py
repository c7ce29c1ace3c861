"""Median ms of `scripts/render.render_view` in a request, between two
synchronizations: traced runs only, on the requests after the profiled
stretch (the syncs would change the stretch's loop)."""

from harness.readers import median_ms

read = median_ms("render_s")
