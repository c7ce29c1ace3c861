"""Device ms of SAM's image encoder a request: the kernels launched inside
the program's span `sam/encode` over the traced stretch (harness/
span_device.py), over the requests in it."""

from harness.span_device import device_ms_per

read = device_ms_per("sam/encode", "sam/encode")
