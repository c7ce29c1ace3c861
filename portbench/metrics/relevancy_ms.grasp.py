"""Device ms of a grasp request's relevancy: the kernels launched inside
the program's span `grasp/relevancy` (the lift of every Gaussian's feature,
the scores and their copy out) over the traced stretch, a request."""

from harness.span_device import device_ms_per

read = device_ms_per("grasp/relevancy", "grasp/relevancy")
