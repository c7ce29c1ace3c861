"""A served query's share (%) of the card's published peaks: the least
time of its work (harness/work.py, `query_least`: projection and SH, K1 on
the reference's walk of the traced request, the lift, the relevancy, the
map written once) over the mean time of the requests before the profiled
stretch, which run with no sync of the benchmark's."""

from harness.readers import mfu

read = mfu("request", "request", "request_s")
