"""The measures that decide `correct` (harness/compare.py) on hand-worked
cases."""

from __future__ import annotations

import math

import pytest
import torch

from harness import compare


def test_gap_of_norms_misses_a_turned_leaf_and_the_difference_sees_it():
    want = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([1.0, 0.0])}
    turned = {"a": torch.tensor([4.0, 3.0]), "b": torch.tensor([1.0, 0.0])}
    assert compare.leaf_gaps(turned, want) == {"a": 0.0, "b": 0.0}
    # |(1, -1)| = sqrt(2), over max(|a| = 5, the median leaf's 3)
    assert compare.leaf_diffs(turned, want)["a"] == pytest.approx(math.sqrt(2.0) / 5.0)


def test_gaps_leave_out_leaves_without_reference_gradient():
    want = {"a": torch.tensor([1.0]), "b": torch.tensor([2.0]), "c": torch.tensor([3.0])}
    got = {"a": torch.tensor([1.0]), "b": torch.tensor([2.0]), "c": torch.tensor([30.0])}
    grads = {"a": torch.tensor([1.0]), "b": torch.tensor([1.0]), "c": torch.tensor([1e-6])}
    assert max(compare.leaf_gaps(got, want).values()) == pytest.approx(9.0)
    assert set(compare.leaf_gaps(got, want, grads)) == {"a", "b"}
    assert max(compare.leaf_diffs(got, want, grads).values()) == 0.0


def test_term_gap():
    assert compare.term_gap({"x": 1.5, "z": 0.0}, {"x": 1.0, "z": 0.0}) == 0.5
    assert compare.term_gap({"z": 1e-9}, {"z": 0.0}) == math.inf


@pytest.mark.parametrize("shift,want", [(0.0, 0.0), (0.5, 0.25)])
def test_map_err_by_group(shift, want):
    ref = torch.zeros(2, 2, 3)
    ref[..., 0] = 2.0
    ref[..., 1:] = 4.0
    got = ref.clone()
    got[0, 0, 0] += shift
    assert compare.map_err(got, ref, {"a": (0, 1), "b": (1, 3)}) == pytest.approx(want)
    assert compare.map_err(got, ref) == pytest.approx(shift / 4.0)
    assert compare.map_err(got[:1], ref) == math.inf


def test_loss_gap_median_leaf_and_worst():
    assert compare.loss_gap([1.0, 2.2], [1.0, 2.0]) == pytest.approx(0.1)
    want = {k: torch.tensor([1.0]) for k in "abc"}
    got = {"a": torch.tensor([1.0]), "b": torch.tensor([1.1]), "c": torch.tensor([5.0])}
    assert compare.median_leaf_gap(got, want) == pytest.approx(0.1)
    assert compare.worst({"a": 0.5, "b": 2.0, "c": 1.0}, 2) == "b 2, c 1"
