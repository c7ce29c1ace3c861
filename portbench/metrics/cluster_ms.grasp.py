"""Host ms of a grasp request's clustering: the program's span
`grasp/cluster` (the selected means copied out, voxelized and joined into
26-connected components), a request over the traced stretch."""

from harness.span_device import host_ms_per

read = host_ms_per(("grasp/cluster",), "grasp/cluster")
