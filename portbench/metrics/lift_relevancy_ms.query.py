"""Median ms of `render.lift` and `query.relevancy_map` in a request,
between two synchronizations: traced runs only, on the requests after the
profiled stretch (the syncs would change the stretch's loop)."""

from harness.readers import median_ms

read = median_ms("lift_relevancy_s")
