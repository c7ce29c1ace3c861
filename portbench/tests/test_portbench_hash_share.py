"""`hash_kernel_share.nerfacto`: the program counters of
`models/encodings.hash_grid_encode`, read after a CPU run of the lookup
(the plain path: 0%), by hand (100%), and nothing without a trace or
without counts (a program that lacks the counters)."""

from __future__ import annotations

import torch

from harness import common

NAME = "hash_kernel_share.nerfacto"


def test_hash_kernel_share_reads_the_program_counters():
    from gaussiangrasper_torch.models.encodings import HashGrid, hash_grid_encode
    from gaussiangrasper_torch.utils.profiler import PROFILER

    ctx = {"trace": object()}
    PROFILER.reset()
    try:
        assert common.read_metric(NAME, {}) is None
        assert common.read_metric(NAME, ctx) is None  # nothing counted
        grid = HashGrid(num_levels=3, log2_hashmap_size=6)
        hash_grid_encode(grid, torch.rand(10, 3))  # no profiler records: not counted
        assert common.read_metric(NAME, ctx) is None
        with torch.profiler.profile():
            hash_grid_encode(grid, torch.rand(10, 3))
        assert PROFILER.counter("hash/lookups") == 30
        assert common.read_metric(NAME, ctx) == 0.0  # CPU tensors: the plain path
        PROFILER.reset()
        with torch.profiler.profile():
            PROFILER.count("hash/lookups", 48)
            PROFILER.count("hash/lookups_kernel", 48)
        assert common.read_metric(NAME, ctx) == 100.0
    finally:
        PROFILER.reset()
