"""Each driver at a tiny size on the CPU path, through its `run` and the
harness's result line, and run.py's refusals."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, TINY
from harness import common

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def result_line(cell_name, traced, capsys):
    cell = TINY[cell_name]()
    drv = common.driver(cell["traffic_data"]["driver"])
    result, checks = common.run_cell(drv, cell, 2 ** 31 + 41, 1.0, traced, common.process_start(), device="cpu")
    keys = ("correct", "attempted", "failed", "metrics", "device", "breakdown")
    capsys.readouterr()
    common.emit({k: result[k] for k in keys if k in result}, checks)
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err, cell


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell_name", sorted(TINY))
def test_driver_prints_the_result_line(cell_name, traced, capsys):
    line, err, cell = result_line(cell_name, traced, capsys)
    want = RESULT_KEYS + (["breakdown"] if traced else []) + ["checks"]
    assert list(line) == want
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell["end_to_end"]}
        assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["checks"]) == set(cell["limits"])
    tail = err.strip().splitlines()[-len(cell["limits"]):]
    assert all(t.startswith("check ") for t in tail)
    if cell_name != "nerfacto-train-800":
        # the CPU's plain path is the reference's own code: it agrees to the
        # bit (nerfacto's hash-table gradients sum in threads, in any order)
        assert line["correct"] is True


def run_py(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_run_py_refuses_without_a_card():
    p = run_py(["--workload", "efd-query-800", "--seed", "3", "--seconds", "1", "--trace", "0"],
               common.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_py_refuses_with_only_the_benchmark(tmp_path):
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("cache", "__pycache__"))
    p = run_py(["--workload", "efd-train-800", "--seed", "3", "--seconds", "1", "--trace", "0"],
               tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""
