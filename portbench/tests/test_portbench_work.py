"""The benchmark's counts of work: hand-worked cases, a loop that walks
every pixel, and the same counts again on the same inputs."""

from __future__ import annotations

import importlib
import math

import numpy as np
import pytest
import torch

from harness import common, work


def ref(mod):
    pkg = common.reference("gaussiangrasper-efd")
    return importlib.import_module(f"{pkg.__name__}.{mod}")


def test_least_time_by_hand():
    assert work.least_s(ops=67e12) == pytest.approx(1.0)
    assert work.least_s(tc_ops=495e12 / 3) == pytest.approx(1.0)
    assert work.least_s(nbytes=3.35e12) == pytest.approx(1.0)
    assert work.least_s(ops=67e12, nbytes=2 * 3.35e12) == pytest.approx(2.0)


def test_k1_and_k2_counts_by_hand():
    k1 = work.k1_least(visits=10, live=4, walked_rows=5, n_rows=2, c=3, pixels=4, tiles=1)
    assert k1["ops"] == 16 * 10 + 6 * 4 and k1["tc_ops"] == 2 * 3 * 4
    assert k1["bytes"] == 4 * (2 * 9 + 5 + 2 + 3 + 4 * 6)
    assert k1["least_s"] == max(k1["ops"] / 67e12 + k1["tc_ops"] / (495e12 / 3), k1["bytes"] / 3.35e12)
    k2 = work.k2_least(visits=10, live=4, walked_rows=5, n_rows=2, c=3, pixels=4, tiles=1)
    assert k2["ops"] == 16 * 10 + 40 * 4 and k2["tc_ops"] == 4 * 3 * 4
    assert k2["bytes"] == 4 * (2 * 2 * 9 + 5 + 2 + 3 + 4 * 6)


def walk_loop(rows, ts, count):
    """Each pixel of one tile, each stream row in order, in Python: the
    pairs walked up to the last composited one and the composited ones."""
    raster = ref("raster")
    visits = np.zeros(ts * ts, np.int64)
    live = np.zeros(ts * ts, np.int64)
    for p in range(ts * ts):
        px, py = p % ts, p // ts
        logt, last = 0.0, -1
        for k in range(count):
            x, y, a, b, c, o = rows[k][:6]
            dx, dy = px - x, py - y
            sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
            alpha = min(raster.ALPHA_CLAMP, o * math.exp(-sigma))
            if sigma < 0 or alpha < raster.ALPHA_CUTOFF:
                continue
            if logt + math.log1p(-alpha) <= raster._LOG_EPS:
                break
            logt += math.log1p(-alpha)
            last = k
            live[p] += 1
        visits[p] = last + 1
    return visits, live


def test_walk_counts_match_a_pixel_loop_and_repeat():
    raster = ref("raster")
    ts, c = 8, 3
    rng = np.random.default_rng(0)
    n = 12
    rows = np.concatenate([rng.uniform(0, ts, (n, 2)),                 # centres
                           np.stack([rng.uniform(0.05, 0.5, n), rng.uniform(-0.02, 0.02, n),
                                     rng.uniform(0.05, 0.5, n)], 1),  # conics
                           rng.uniform(0.3, 0.99, (n, 1)),             # opacities
                           rng.uniform(0, 1, (n, c))], 1).astype(np.float32)
    attrs = torch.tensor(rows)
    gidx = torch.arange(n, dtype=torch.int32)
    starts, counts = torch.zeros(1, dtype=torch.int32), torch.tensor([n], dtype=torch.int32)
    bg = torch.zeros(c)
    res = raster.composite_pairs_fwd_plain(gidx, starts, counts, attrs, bg, 1, ts, walk_counts=True)
    again = raster.composite_pairs_fwd_plain(gidx, starts, counts, attrs, bg, 1, ts, walk_counts=True)
    visits, live = walk_loop(rows.astype(np.float64), ts, n)
    np.testing.assert_array_equal(res[4][0].numpy(), visits)
    np.testing.assert_array_equal(res[5][0].numpy(), live)
    assert torch.equal(res[4], again[4]) and torch.equal(res[5], again[5])
    assert int(live.sum()) > 0 and int((visits > live).sum()) > 0


def test_step_parts_add_up():
    k = work.k1_least(1e6, 5e5, 1e5, 1000, 39, 640000, 625)
    step = work.splat_step_least(1000, 25, 32, 512, 128, 800, 800, 25600, 1000, k, k,
                                 118, 110, 10, 100)
    assert step["step"] == pytest.approx(sum(v for n, v in step.items() if n != "step"))
    q = work.query_least(1000, 25, 32, 512, 128, 800, 800, 4, k)
    assert q["lift"] == pytest.approx(2.0 * 640000 * (32 * 128 + 128 * 512) / 67e12)
    nf = work.nerfacto_step_least(4096, [256, 96, 48], [5, 5, 16], 2, [352, 352, 10408],
                                  1000, 2000)
    assert nf["step"] == pytest.approx(nf["march"] + nf["adam"])
