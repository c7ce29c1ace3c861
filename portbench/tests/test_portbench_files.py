"""BENCHMARK.json's entries, names and limits, and every file a cell
names found by its name."""

from __future__ import annotations

import re

import pytest

from conftest import BENCH
from harness import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FILE_CHARS = re.compile(r"^[A-Za-z0-9_.\-/]+$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

BENCH_JSON = common.benchmark()


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH_JSON) == {"command", "paths", "run_seconds", "configs", "workloads",
                               "end_to_end", "per_layer"}
    assert BENCH_JSON["command"] == ["python3", "portbench/run.py"]
    assert BENCH_JSON["paths"] == ["portbench"]
    assert all(line(w) for w in BENCH_JSON["command"])
    assert (common.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_run_seconds_fits_24_cells():
    rs = BENCH_JSON["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (rs + 60) * (2 + 14 * 24) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH_JSON["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH_JSON["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    for m in BENCH_JSON["end_to_end"] + BENCH_JSON["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH_JSON["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in BENCH_JSON["workloads"]) <= max(1, len(pairs) // 4)


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH_JSON["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert 0.01 <= e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics_have_readers_layers_and_cells():
    e2e = {m["name"]: m for m in BENCH_JSON["end_to_end"]}
    cells = {w["name"] for w in BENCH_JSON["workloads"]}
    for m in BENCH_JSON["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert line(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]
        reader = common.load_module(BENCH / "metrics" / f"{m['name']}.py", "reader_" + m["name"])
        assert callable(reader.read) and reader.__doc__
        assert reader.read({}) is None  # nothing to read: no number, never 0
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_resolves_and_reports_enough():
    used = set()
    for w in BENCH_JSON["workloads"]:
        c = common.cell(w["name"])
        used.add(w["config"])
        assert c["config_data"]["name"] == w["config"]
        assert (BENCH / "drivers" / f"{c['traffic_data']['driver']}.py").exists()
        e2e = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c["per_layer"], w["name"]
        assert c["limits"] and all(isinstance(v, (int, float)) for v in c["limits"].values())
        drv = common.driver(c["traffic_data"]["driver"])
        assert hasattr(drv, "Run") and hasattr(drv, "Check") and hasattr(drv, "FAULTS")
    assert used == {c["name"] for c in BENCH_JSON["configs"]}


def test_config_files_under_paths_and_distinct():
    files = [c["file"] for c in BENCH_JSON["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH_JSON["configs"]:
        assert c["file"].startswith("portbench/")
        data = common.load_json(common.ROOT / c["file"])
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        for key in ("assumed", "deployment"):
            assert data[key]


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH.parent).as_posix()
                                        for p in BENCH.rglob("*") if p.is_file()
                                        and "cache" not in p.parts and "__pycache__" not in p.parts))
def test_file_names_use_name_characters(path):
    assert FILE_CHARS.match(path) and len(path) <= 200
