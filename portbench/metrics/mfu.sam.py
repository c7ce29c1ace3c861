"""A segmentation request's share (%) of the card's published peaks: the
least time of its work (harness/sam_work.py: the encoder, the decoder's 64
prompts, the upscaled logits) over the mean time of the requests before
the profiled stretch, which run with no sync of the benchmark's."""

from harness.readers import mfu

read = mfu("request", "least_s", "request_s")
