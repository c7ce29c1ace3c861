"""Tiny cells of the benchmark for the CPU tests (run them with
`python -m pytest portbench/tests`; the repository's `tests/` does not
collect them). Tests that need the card are marked `gpu` and skip here."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import common  # noqa: E402

SMALL_SCENE = {"width": 64, "height": 48, "n_views": 4, "seed_points": 2000, "layout_seed": 0,
               "feature_downscale": 4}


def _cell(name: str) -> dict:
    return copy.deepcopy(common.cell(name))


def tiny_splat_train() -> dict:
    c = _cell("efd-train-800")
    conf = c["config_data"]
    conf["scene"] = dict(SMALL_SCENE)
    conf["capacity"] = 4096
    conf["model"]["raster"].update(tile_size=16, max_gaussians_per_tile=256)
    conf["sampler"] = {"max_groups": 4, "pairs_per_group": 16, "num_points": 32, "clip_dim": 512}
    c["traffic_data"].update(start_step=4089, warmup_steps=11, trace_after=1, trace_phase=1,
                             trace_steps=2, device_after=0, device_steps=1)
    return c


def tiny_nerf_train() -> dict:
    c = _cell("nerfacto-train-800")
    conf = c["config_data"]
    conf["scene"] = dict(SMALL_SCENE)
    conf["model"].update(hash_levels=4, log2_hashmap_size=10, num_proposal_samples=[16, 8],
                         num_fine=8, proposal_log2_hashmap_size=8)
    conf["trainer"]["rays_per_batch"] = 64
    c["traffic_data"].update(warmup_steps=5, trace_after=1, trace_steps=2)
    return c


def tiny_query() -> dict:
    c = _cell("efd-query-800")
    c["config_data"]["model"]["raster"].update(tile_size=16, max_gaussians_per_tile=256)
    c["traffic_data"].update(gaussians=2000, width=64, height=48, focal=80.0, warmup_requests=2,
                             sample_from=4, sampled=2, lift_pixels=256, trace_after=1,
                             trace_requests=2)
    return c


TINY = {"efd-train-800": tiny_splat_train, "nerfacto-train-800": tiny_nerf_train,
        "efd-query-800": tiny_query}


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
