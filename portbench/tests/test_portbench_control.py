"""The control on the card: the plain reference in TF32, the precision
below the configurations' float32, put in the program's place, comes out
not correct, while the program at the same seed comes out correct. At a
size a test run holds; the cells' own sizes are read by calibrate.py
(PERF.md gives those readings)."""

from __future__ import annotations

import pytest

import calibrate
from conftest import TINY
from harness import common


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", sorted(TINY))
def test_control_fails_where_the_program_passes(cell_name, cuda_device):
    cell = TINY[cell_name]()
    drv = common.driver(cell["traffic_data"]["driver"])
    got = calibrate.readings(cell, drv, 2 ** 31 + 5, None, True, 2.0, cuda_device)
    limits = cell["limits"]
    assert all(v <= limits[k] for k, v in got["sound"].items()), got["sound"]
    assert any(v > limits[k] for k, v in got["control"].items()), got["control"]
