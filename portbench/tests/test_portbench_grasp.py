"""The `efd-grasp-query` cell's driver at a tiny size on the CPU: 20,000
Gaussians with 8 objects of 1,000, voxels of 0.05; its result line is
correct, each planted fault makes it not correct by the number meant to
catch it, the reference's scipy labelling agrees with the program's
union-find, and the new readers find nothing without a trace and read a
small synthetic trace as counted by hand."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import BENCH
from harness import common

CELL = "efd-grasp-query"
READERS = ("relevancy_ms.grasp", "cluster_ms.grasp", "idle_share.grasp")
CAUGHT_BY = {"six_connected": {"cluster_mismatch"}, "approach_kept": {"grasp_gap"},
             "threshold_05": {"selected_mismatch"}}


def tiny_grasp() -> dict:
    import copy

    c = copy.deepcopy(common.cell(CELL))
    c["traffic_data"].update(gaussians=20000, object_size=1000, voxel=0.05,
                             warmup_requests=2, sample_from=4, sampled=2, trace_after=1,
                             trace_requests=2)
    return c


def run(traced: bool, fault=None):
    cell = tiny_grasp()
    drv = common.driver(cell["traffic_data"]["driver"])
    return common.run_cell(drv, cell, 2 ** 31 + 59, 1.0, traced, common.process_start(),
                           device="cpu", fault=fault)


@pytest.mark.parametrize("traced", [False, True])
def test_grasp_driver_reports_correct(traced):
    result, checks = run(traced)
    assert result["correct"] is True, checks.table()
    assert result["attempted"] >= 4 and result["failed"] == 0
    if traced:
        # a trace taken without a card holds no runtime launches
        assert "relevancy_ms.grasp" not in result["metrics"]
        assert result["metrics"]["cluster_ms.grasp"]["value"] > 0
    else:
        assert set(result["metrics"]) == {"query_p50_ms", "query_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", sorted(CAUGHT_BY))
def test_grasp_fault_makes_the_run_incorrect(fault):
    result, checks = run(False, fault)
    assert result["correct"] is False
    failing = {k for k, row in checks.table().items() if not row["value"] <= row["limit"]}
    assert failing & CAUGHT_BY[fault], checks.table()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_labels_the_cluster_as_the_program_does(seed):
    from gaussiangrasper_torch.scripts import grasp

    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.normal(0.0, 0.1, (600, 3)), rng.uniform(-1, 1, (300, 3))])
    want = grasp.largest_cluster(pts, 0.04)
    got = common.reference("gaussiangrasper-efd", "grasp").largest_cluster(pts, 0.04)
    assert 0 < want.sum() < len(pts) and np.array_equal(got, want)


@pytest.mark.parametrize("name", READERS)
def test_grasp_readers_find_nothing_without_a_trace(name):
    reader = common.load_module(BENCH / "metrics" / f"{name}.py", "reader_" + name)
    assert reader.read({}) is None
    assert reader.read({"trace": None}) is None


def synthetic_trace():
    """Two requests on one thread: a kernel of 20 us launched inside
    `ggt::grasp/relevancy` and 300 us of host in `ggt::grasp/cluster`."""
    from harness.trace import Trace

    ev = [{"name": "bench::window", "cat": "user_annotation", "ph": "X", "ts": 0, "dur": 2000}]
    for r, t in enumerate((0, 1000)):
        ev += [{"name": "ggt::grasp/relevancy", "cat": "cpu_op", "ph": "X", "ts": t + 10,
                "dur": 50, "tid": 1},
               {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ph": "X", "ts": t + 20,
                "dur": 2, "tid": 1, "args": {"correlation": r + 1}},
               {"name": "gemm", "cat": "kernel", "ph": "X", "ts": t + 30, "dur": 20, "tid": 7,
                "args": {"correlation": r + 1}},
               {"name": "ggt::grasp/cluster", "cat": "cpu_op", "ph": "X", "ts": t + 100,
                "dur": 300, "tid": 1}]
    return Trace(ev)


@pytest.mark.parametrize("name,want", [("relevancy_ms.grasp", 0.02), ("cluster_ms.grasp", 0.3)])
def test_grasp_readers_read_a_synthetic_trace(name, want):
    reader = common.load_module(BENCH / "metrics" / f"{name}.py", "reader_" + name)
    assert reader.read({"trace": synthetic_trace()}) == pytest.approx(want)
