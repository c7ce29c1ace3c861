"""`gather_kernel_share.efd_train`: the program counters of
`ops/pixel_gather.gather_pixels`, read after a CPU run of the gather (the
plain path: 0%), by hand (100%), and nothing without a trace or without
counts (a program that lacks the counters)."""

from __future__ import annotations

import torch

from harness import common

NAME = "gather_kernel_share.efd_train"


def test_gather_kernel_share_reads_the_program_counters():
    from gaussiangrasper_torch.ops.pixel_gather import gather_pixels
    from gaussiangrasper_torch.utils.profiler import PROFILER

    ctx = {"trace": object()}
    fea = torch.rand(6, 5, 7)[..., 2:6]
    idx = torch.tensor([[0, 0], [5, 4], [0, 0]], dtype=torch.int32)
    PROFILER.reset()
    try:
        assert common.read_metric(NAME, {}) is None
        assert common.read_metric(NAME, ctx) is None  # nothing counted
        gather_pixels(fea, idx)  # no profiler records: not counted
        assert common.read_metric(NAME, ctx) is None
        with torch.profiler.profile():
            gather_pixels(fea, idx)
        assert PROFILER.counter("efd/gather_rows") == 3
        assert common.read_metric(NAME, ctx) == 0.0  # CPU tensors: the plain path
        PROFILER.reset()
        with torch.profiler.profile():
            PROFILER.count("efd/gather_rows", 52_200)
            PROFILER.count("efd/gather_rows_kernel", 52_200)
        assert common.read_metric(NAME, ctx) == 100.0
    finally:
        PROFILER.reset()
