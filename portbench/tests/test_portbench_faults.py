"""A run with the timed path broken underneath comes out not correct: each
fault the cell can have, planted in the program at a tiny size on the CPU
(the look for a card skipped), through the whole run (`run_cell`), caught by
the number meant to catch it."""

from __future__ import annotations

import pytest

from conftest import TINY
from harness import common

CASES = [(name, fault) for name, make in sorted(TINY.items())
         for fault in common.driver(make()["traffic_data"]["driver"]).FAULTS]

CAUGHT_BY = {
    "unchanged": {"delta_gap", "delta_gap_median"},
    "refine_unchanged": {"refine_alive"},
    "half_batch": {"grad_gap"},
    "batch_altered": {"batch_errors"},
    "answer": {"relevancy_err"},
    "map_altered": {"map_err"},
}


@pytest.mark.parametrize("cell_name,fault", CASES)
def test_fault_makes_the_run_incorrect(cell_name, fault):
    cell = TINY[cell_name]()
    drv = common.driver(cell["traffic_data"]["driver"])
    result, checks = common.run_cell(drv, cell, 2 ** 31 + 77, 1.0, False, common.process_start(),
                             device="cpu", fault=fault)
    assert result["correct"] is False
    failing = {k for k, row in checks.table().items() if not row["value"] <= row["limit"]}
    assert failing & CAUGHT_BY[fault], checks.table()
