"""Host ms a segmentation request spends in the program's spans
`segment/preprocess` (the processor's resize, normalisation and upload)
and `segment/post` (the masks' upscaling, their copy out and the ordering
loop), over the traced stretch."""

from harness.span_device import host_ms_per

read = host_ms_per(("segment/preprocess", "segment/post"), "segment/preprocess")
