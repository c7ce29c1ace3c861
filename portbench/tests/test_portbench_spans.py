"""The program-span readers (harness/spans.py) on a hand-built Chrome
trace that mixes the benchmark's `bench::` spans, the program's `ggt::`
spans (cpu_op events, one of them on a second thread), a
`gpu_user_annotation`, kernels, copies and runtime launches; times in
microseconds, every sum worked by hand in the comments."""

from __future__ import annotations

import pytest

from conftest import BENCH
from harness import common, spans
from harness.trace import Trace

NEW = {"idle_forward_ms.efd_train": 0.128, "idle_backward_ms.efd_train": 0.119,
       "idle_adam_ms.efd_train": 0.049, "host_syncs.efd_train": 3.0}


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


def kernel(name, a, b, corr, launch_ts, tid=1, cat="kernel"):
    return [X(cat, name, a, b - a, tid=7, correlation=corr),
            X("cuda_runtime", "cudaLaunchKernel" if cat == "kernel" else "cudaMemcpyAsync",
              launch_ts, 2, tid=tid, correlation=corr)]


def events(program=True):
    ev = [X("user_annotation", "bench::window", 0, 1000),
          X("user_annotation", "bench::train_step", 10, 480),
          X("gpu_user_annotation", "bench::train_step", 30, 420, tid=7),
          X("cpu_op", "aten::add", 25, 3),
          X("cuda_runtime", "cudaStreamSynchronize", 156, 4, correlation=11)]
    for name, a, b, corr, ts, *tid in (
            ("k1", 30, 60, 1, 25), ("k2", 100, 150, 2, 90), ("k3", 240, 280, 3, 230),
            ("k4", 330, 340, 4, 310, 2), ("k5", 370, 400, 5, 365), ("k6", 440, 450, 6, 430)):
        ev += kernel(name, a, b, corr, ts, *tid)
    ev += kernel("Memcpy DtoH (Device -> Pageable)", 160, 162, 7, 155, cat="gpu_memcpy")
    ev += kernel("Memcpy DtoH (Device -> Pinned)", 460, 461, 8, 458, cat="gpu_memcpy")
    ev += kernel("Memcpy DtoH (Device -> Pageable)", 600, 601, 9, 590, cat="gpu_memcpy")
    ev += kernel("Memcpy HtoD (Pageable -> Device)", 500, 505, 10, 430, cat="gpu_memcpy")
    ev += kernel("Memcpy DtoH (Device -> Pageable)", 345, 346, 12, 342, tid=2, cat="gpu_memcpy")
    if program:
        ev += [X("cpu_op", "ggt::train_step", 12, 470, step=5),
               X("cpu_op", "ggt::train_step/forward", 15, 200),
               X("cpu_op", "ggt::train_step/forward/bin", 20, 50),
               X("cpu_op", "ggt::train_step/backward", 220, 200),
               X("cpu_op", "ggt::composite_bwd", 300, 60, tid=2),
               X("cpu_op", "ggt::train_step/adam", 425, 50)]
    return ev


# Busy, merged: [30,60] [100,150] [160,162] [240,280] [330,340] [345,346] [370,400]
# [440,450] [460,461] [500,505] [600,601] = 180. Gaps: [0,30] 30, [60,100] 40,
# [150,160] 10, [162,240] 78, [280,330] 50, [340,345] 5, [346,370] 24, [400,440] 40,
# [450,460] 10, [461,500] 39, [505,600] 95, [601,1000] 399.


@pytest.fixture
def trace():
    return Trace(events())


def test_idle_within_sums_the_gaps_that_begin_inside(trace):
    want = {"train_step/forward": 40 + 10 + 78, "train_step/forward/bin": 40,
            "train_step/backward": 50 + 5 + 24 + 40, "train_step/adam": 10 + 39,
            # on autograd's thread, while thread 1 is inside backward
            "composite_bwd": 5 + 24, "train_step": 296, "refine": 0}
    for root, us in want.items():
        assert spans.idle_within(trace, root) == pytest.approx(us * 1e-6, abs=1e-12), root


def test_syncs_within_counts_device_to_host_copies_on_the_span_thread(trace):
    # 7 (thread 1, in forward), 8 (in adam), 12 (thread 2, in composite_bwd); 9 falls
    # after every span, 10 is host to device, 11 has no copy
    assert spans.syncs_within(trace) == 3
    assert spans.syncs_within(trace, "train_step") == 2
    assert spans.syncs_within(trace, "train_step/adam") == 1
    assert spans.syncs_within(trace, "composite_bwd") == 1
    assert spans.syncs_within(trace, "train_step/backward") == 0


def test_steps_and_program_spans(trace):
    assert spans.steps(trace, "train_step") == 1
    assert spans.steps(trace, "nerf_step") == 0
    assert {p for _, _, p, _ in spans.program_spans(trace)} == {
        "train_step", "train_step/forward", "train_step/forward/bin", "train_step/backward",
        "composite_bwd", "train_step/adam"}


def test_trace_reads_as_before_the_program_spans(trace):
    """What the accepted readers and the breakdown take is the same with and
    without the program's spans, and as worked by hand."""
    before = Trace(events(program=False))
    assert trace.spans == before.spans == [(10.0, 490.0, "train_step")]
    assert trace.busy == before.busy
    assert trace.busy_s == before.busy_s == pytest.approx(180e-6)
    assert trace.idle_gaps() == before.idle_gaps()
    assert [g[0] for g in trace.idle_gaps()] == ["none", "train_step"]
    assert [g[1] for g in trace.idle_gaps()] == pytest.approx([524e-6, 296e-6])
    assert trace.device_ops() == before.device_ops()


def test_readers_on_the_fixture(trace):
    for name, value in NEW.items():
        assert common.read_metric(name, {"trace": trace}) == pytest.approx(value), name
    # the three idle metrics of a step never pass the breakdown's train_step idle
    idle = dict(trace.idle_gaps())["train_step"]
    assert sum(NEW[f"idle_{k}_ms.efd_train"] for k in ("forward", "backward", "adam")) \
        <= 1e3 * idle + 1e-9


@pytest.mark.parametrize("name", sorted(NEW) + [
    "pair_keep_share.efd_train", "idle_bin_ms.query", "host_syncs.query",
    "idle_render_ms.nerfacto", "host_syncs.nerfacto"])
def test_new_readers_return_none_without_a_trace_or_program_spans(name):
    assert common.read_metric(name, {}) is None
    if name != "pair_keep_share.efd_train":
        assert common.read_metric(name, {"trace": Trace(events(program=False))}) is None


def test_pair_keep_share_reads_the_program_counters(trace):
    import torch

    from gaussiangrasper_torch.utils.profiler import PROFILER

    PROFILER.reset()
    PROFILER.count("bin/pairs_sorted", 40)  # no profiler records: not counted
    assert common.read_metric("pair_keep_share.efd_train", {"trace": trace}) is None
    with torch.profiler.profile():
        PROFILER.count("bin/pairs_sorted", 40)
        PROFILER.count("bin/pairs_kept", torch.tensor(4))
        PROFILER.count("bin/pairs_kept", torch.tensor(6))
    assert common.read_metric("pair_keep_share.efd_train", {"trace": trace}) == 25.0
    PROFILER.reset()


def test_the_nine_metrics_are_listed_in_their_cells():
    per = {m["name"]: m for m in common.benchmark()["per_layer"]}
    cells = {"efd_train": "efd-train-800", "query": "efd-query-800",
             "nerfacto": "nerfacto-train-800"}
    names = [n for n in per if n.split(".")[0] in (
        "idle_forward_ms", "idle_backward_ms", "idle_adam_ms", "host_syncs", "pair_keep_share",
        "idle_bin_ms", "idle_render_ms")]
    assert len(names) == 9
    for n in names:
        assert per[n]["workloads"] == [cells[n.split(".")[1]]]
        assert (BENCH / "metrics" / f"{n}.py").exists()
