"""Share (%) of the traced grasp requests' occupied voxels that the CUDA
kernels of `csrc/voxel_cluster.cu` label: 100 x the program counter
`grasp/voxels_kernel` over `grasp/voxels`, both counted in the grasp
request's clustering (`scripts/grasp.largest_cluster`,
`ops/voxel_cluster.largest_component`)."""

from harness.spans import keep_share

read = keep_share("grasp/voxels_kernel", "grasp/voxels")
