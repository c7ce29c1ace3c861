"""The `sam-h-segment-800` cell's driver at a tiny size on the CPU: SAM at
hidden 64, 4 heads, 4 blocks with global attention at 1 and 3, windows of
4 over a 10 x 10 grid (so the windows pad), on 96 x 80 views; its result
line is correct, each planted fault makes it not correct by the number
meant to catch it, the new readers find nothing without a trace or
without runtime launches, and read a small synthetic trace as counted by
hand."""

from __future__ import annotations

import pytest

from conftest import BENCH
from harness import common

CELL = "sam-h-segment-800"
DEVICE_READERS = ("encoder_ms.sam", "global_attn_share.sam", "window_attn_share.sam",
                  "encoder_roofline.sam")
READERS = DEVICE_READERS + ("mfu.sam", "idle_share.sam", "host_ms.sam")
CAUGHT_BY = {"windowed_global": {"embed_err"}, "no_rel_pos": {"embed_err"},
             "pad_top_left": {"embed_err"}, "order_reversed": {"id_mismatch"}}


def tiny_sam() -> dict:
    import copy

    c = copy.deepcopy(common.cell(CELL))
    hf = c["config_data"]["hf_config"]
    hf["vision_config"].update(hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
                               global_attn_indexes=[1, 3], window_size=4, image_size=160,
                               num_pos_feats=16, output_channels=32, mlp_dim=256)
    hf["prompt_encoder_config"].update(hidden_size=32, image_size=160)
    hf["mask_decoder_config"].update(hidden_size=32, mlp_dim=64, num_attention_heads=4,
                                     iou_head_hidden_dim=32)
    c["traffic_data"].update(scene={"width": 80, "height": 96, "n_views": 2, "seed_points": 200,
                                    "layout_seed": 0, "feature_downscale": 4},
                             warmup_requests=1, sample_from=3, sampled=2, trace_after=1,
                             trace_requests=2)
    return c


def run(traced: bool, fault=None):
    cell = tiny_sam()
    drv = common.driver(cell["traffic_data"]["driver"])
    return common.run_cell(drv, cell, 2 ** 31 + 93, 3.0, traced, common.process_start(),
                           device="cpu", fault=fault)


@pytest.mark.parametrize("traced", [False, True])
def test_sam_driver_reports_correct(traced):
    result, checks = run(traced)
    assert result["correct"] is True, checks.table()
    assert result["attempted"] >= 3 and result["failed"] == 0
    if traced:
        got = result["metrics"]
        # a trace taken without a card holds no runtime launches
        assert not set(DEVICE_READERS) & set(got), got
        assert got["host_ms.sam"]["value"] > 0
        assert 0 < got["mfu.sam"]["value"] < 100
    else:
        assert set(result["metrics"]) == {"query_p50_ms", "query_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", sorted(CAUGHT_BY))
def test_sam_fault_makes_the_run_incorrect(fault):
    result, checks = run(False, fault)
    assert result["correct"] is False
    failing = {k for k, row in checks.table().items() if not row["value"] <= row["limit"]}
    assert failing & CAUGHT_BY[fault], checks.table()


@pytest.mark.parametrize("name", READERS)
def test_sam_readers_find_nothing_without_a_trace(name):
    reader = common.load_module(BENCH / "metrics" / f"{name}.py", "reader_" + name)
    assert reader.read({}) is None
    assert reader.read({"trace": None, "request_s": 0.0, "work": None}) is None


def synthetic_trace(launches: bool = True):
    """Two requests on one thread: in each, kernels of 30 us (window
    attention), 60 us (global attention) and 10 us (the rest of the
    encoder) launched inside `ggt::sam/encode`, one of 100 us (the
    decoder) after it, and 40 + 100 us of host spans."""
    from harness.trace import Trace

    ev = [{"name": "bench::window", "cat": "user_annotation", "ph": "X", "ts": 0, "dur": 2000}]

    def op(name, ts, dur):
        ev.append({"name": name, "cat": "cpu_op", "ph": "X", "ts": ts, "dur": dur, "tid": 1})

    def kernel(launched, ts, dur, corr):
        if launches:
            ev.append({"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ph": "X",
                       "ts": launched, "dur": 2, "tid": 1, "args": {"correlation": corr}})
        ev.append({"name": f"kernel_{corr}", "cat": "kernel", "ph": "X", "ts": ts, "dur": dur,
                   "tid": 7, "args": {"correlation": corr}})

    for r, t in enumerate((0, 1000)):
        op("ggt::segment/preprocess", t + 10, 40)
        op("ggt::sam/encode", t + 60, 300)
        op("ggt::sam/encode/window_attn", t + 70, 50)
        kernel(t + 80, t + 100, 30, 10 * r + 1)
        op("ggt::sam/encode/global_attn", t + 130, 50)
        kernel(t + 140, t + 150, 60, 10 * r + 2)
        kernel(t + 200, t + 250, 10, 10 * r + 3)
        op("ggt::sam/decode", t + 380, 50)
        kernel(t + 400, t + 420, 100, 10 * r + 4)
        op("ggt::segment/post", t + 500, 100)
    return Trace(ev)


@pytest.mark.parametrize("name,want", [("encoder_ms.sam", 0.1), ("global_attn_share.sam", 60.0),
                                       ("window_attn_share.sam", 30.0),
                                       ("encoder_roofline.sam", 50.0), ("host_ms.sam", 0.14)])
def test_sam_readers_read_a_synthetic_trace(name, want):
    reader = common.load_module(BENCH / "metrics" / f"{name}.py", "reader_" + name)
    ctx = {"trace": synthetic_trace(), "work": {"encoder": {"least_s": 5e-5}}}
    assert reader.read(ctx) == pytest.approx(want)
    if name in DEVICE_READERS:
        assert reader.read(dict(ctx, trace=synthetic_trace(launches=False))) is None
