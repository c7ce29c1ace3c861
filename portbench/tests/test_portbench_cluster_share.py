"""`cluster_kernel_share.grasp`: the program counters of the grasp
request's clustering, read after a CPU run of `largest_cluster` (the host
path: 0%), by hand (100%), and nothing without a trace or without counts
(a program that lacks the counters)."""

from __future__ import annotations

import numpy as np
import torch

from harness import common

NAME = "cluster_kernel_share.grasp"


def test_cluster_kernel_share_reads_the_program_counters():
    from gaussiangrasper_torch.scripts.grasp import largest_cluster
    from gaussiangrasper_torch.utils.profiler import PROFILER

    ctx = {"trace": object()}
    points = np.random.default_rng(3).normal(0.0, 0.1, (300, 3))
    PROFILER.reset()
    try:
        assert common.read_metric(NAME, {}) is None
        assert common.read_metric(NAME, ctx) is None  # nothing counted
        largest_cluster(points, 0.04)  # no profiler records: not counted
        assert common.read_metric(NAME, ctx) is None
        with torch.profiler.profile():
            largest_cluster(points, 0.04)
        assert PROFILER.counter("grasp/voxels") > 0
        assert common.read_metric(NAME, ctx) == 0.0  # no card: the host path
        PROFILER.reset()
        with torch.profiler.profile():
            PROFILER.count("grasp/voxels", 8300)
            PROFILER.count("grasp/voxels_kernel", 8300)
            PROFILER.count("grasp/voxels", 100)
        assert common.read_metric(NAME, ctx) == 100.0 * 8300 / 8400
    finally:
        PROFILER.reset()
