"""Cells, results and guards shared by every driver.

A cell is an entry of BENCHMARK.json's `workloads`: a configuration file
`configs/<config>.json`, a traffic file `traffic/<traffic>.json` that names
its driver (`drivers/<driver>.py`), and the limits of its correctness
check, `limits/<cell>.json`. Per-layer metrics are readers
`metrics/<metric>.py`. All are found by name.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
CACHE = BENCH / "cache"
"""Datasets and any build cache the benchmark keeps, at fixed paths inside
the checkout (gitignored)."""

JAX_NAMES = ("jax", "jaxlib", "flax", "optax", "orbax", "gaussiangrasper_tpu")


class StopWindow(Exception):
    """Raised by a step gate to end the program's loop at a deadline or a
    step count; the loop's own `finally` closes what it opened."""


def process_start() -> float:
    """This process's start as a `time.time()` value, from /proc; the
    interpreter's first reading of the clock where /proc is absent."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19])  # starttime, clock ticks after boot
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _FIRST_CLOCK


_FIRST_CLOCK = time.time()


def load_json(path: Path) -> Any:
    return json.loads(Path(path).read_text())


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The workload entry of BENCHMARK.json named `name`, with its
    configuration, traffic and limits loaded under "config_data",
    "traffic_data" and "limits"."""
    bench = benchmark()
    match = [w for w in bench["workloads"] if w["name"] == name]
    if not match:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have "
                         f"{[w['name'] for w in bench['workloads']]}")
    w = dict(match[0])
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    w["config_data"] = load_json(ROOT / conf["file"])
    w["traffic_data"] = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    w["limits"] = load_json(BENCH / "limits" / f"{name}.json")
    w["end_to_end"] = [m for m in bench["end_to_end"]
                       if "workloads" not in m or name in m["workloads"]]
    w["per_layer"] = [m for m in bench["per_layer"]
                      if "workloads" not in m or name in m["workloads"]]
    return w


def load_module(path: Path, name: str):
    """A module from a file path (names here may hold dots or dashes)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_package(path: Path, name: str):
    """A directory with an __init__.py as package `name`, so its modules'
    relative imports resolve (the reference directories are named after
    configurations, which hold dashes)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, Path(path) / "__init__.py",
                                                  submodule_search_locations=[str(path)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reference(config: str, module: Optional[str] = None):
    """The plain reference package of a configuration,
    portbench/reference/<config>/, or its module `module`."""
    pkg = load_package(BENCH / "reference" / config, "ref_" + config.replace("-", "_"))
    return pkg if module is None else importlib.import_module(f"{pkg.__name__}.{module}")


def driver(name: str):
    return load_module(BENCH / "drivers" / f"{name}.py", f"portbench_driver_{name}")


def read_metric(name: str, ctx: dict) -> Optional[float]:
    """The per-layer metric `name` from its reader, metrics/<name>.py
    (`read(ctx)` -> a number, or None where it finds nothing to read)."""
    mod = load_module(BENCH / "metrics" / f"{name}.py", "portbench_metric_" + name.replace(".", "_"))
    value = mod.read(ctx)
    return None if value is None else float(value)


def per_layer(cell: dict, ctx: dict) -> Dict[str, dict]:
    """Every per-layer metric of the cell that its reader finds something
    to read for; the others are left out of the line."""
    out = {}
    for m in cell["per_layer"]:
        v = read_metric(m["name"], ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def jax_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(JAX_NAMES))


@contextlib.contextmanager
def program_stdout_to_stderr():
    """The program prints progress on stdout; the result line must be
    stdout's last, so the program's prints go to stderr meanwhile."""
    with contextlib.redirect_stdout(sys.stderr):
        yield


class Checks:
    """The numbers that decide `correct`, each beside its limit; a number
    passes when it is finite and at or below its limit."""

    def __init__(self, limits: Dict[str, float]):
        self.limits = limits
        self.values: Dict[str, float] = {}

    def add(self, name: str, value: float) -> None:
        if name not in self.limits:
            raise KeyError(f"no limit for {name!r}; have {sorted(self.limits)}")
        self.values[name] = float(value)

    def passed(self) -> bool:
        missing = set(self.limits) - set(self.values)
        return not missing and all(
            math.isfinite(v) and v <= self.limits[k] for k, v in self.values.items())

    def table(self) -> Dict[str, Dict[str, float]]:
        return {k: {"value": self.values.get(k, float("nan")), "limit": self.limits[k]}
                for k in self.limits}

    def lines(self) -> Iterable[str]:
        for k, row in self.table().items():
            ok = math.isfinite(row["value"]) and row["value"] <= row["limit"]
            yield f"check {k}: {row['value']!r} limit {row['limit']!r} {'ok' if ok else 'FAIL'}"


def cpu(x):
    """A detached copy on the host of a tensor (anything else as it is)."""
    import torch

    return x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x


def sync() -> None:
    """Wait for the card; nothing on a machine without one (the CPU tests
    drive the same code)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def peak_bytes() -> int:
    import torch

    return int(torch.cuda.max_memory_allocated()) if torch.cuda.is_available() else 0


def device_info(count: int, peak: int) -> dict:
    import torch

    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak)}


def require_devices(chips: int) -> None:
    """Exit without a result where the card or enough cards are missing."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench: torch.cuda.is_available() is False; no result")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell asks for {chips} cards, "
                         f"torch.cuda.device_count() is {torch.cuda.device_count()}; no result")


def emit(result: dict, checks: Checks) -> None:
    """The checks, each number beside its limit, as stderr's last lines;
    then the result line as stdout's last, with the same numbers and limits
    under a key of their own that comes last ("checks")."""
    for line in checks.lines():
        print(line, file=sys.stderr)
    sys.stderr.flush()
    out = dict(result)
    out["checks"] = checks.table()
    print(json.dumps(out), flush=True)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them, or ''."""
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def host_snapshot() -> tuple:
    """(wall, this process's CPU seconds), for `host_line`."""
    return time.perf_counter(), time.process_time()


def host_line(a: tuple, b: tuple) -> str:
    """The CPU cores this process kept busy between two snapshots, on
    average: the host's share of a host-paced loop."""
    wall = b[0] - a[0]
    return (f"portbench host over the window: wall {wall:.3f} s, "
            f"process cpu {(b[1] - a[1]) / max(wall, 1e-9):.3f} cores")


class Stages:
    """Seconds of each stage of a run, printed to stderr as each ends."""

    def __init__(self):
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        print(f"portbench stage {name}: {now - self.t:.3f} s", file=sys.stderr, flush=True)
        self.t = now


def run_cell(drv, cell: dict, seed: int, seconds: float, traced: bool, t_proc: float,
             device: str = "cuda", fault: Optional[str] = None):
    """One run of a cell through its driver's `Run` and `Check`: set-up
    (with a training loop's warm-up), the window, the metrics, then the
    check once the program's state is freed. Returns (result, checks).
    `device` "cpu" and a planted `fault` are for the CPU tests; the
    benchmark runs on the card with none.

    `setup_s` runs from the process's start to the window's start. With
    --trace 0 the metrics are the run's end-to-end ones; with --trace 1 the
    per-layer readers' (`per_layer`) on the driver's `layer_context`."""
    st = Stages()
    r = drv.Run(cell, seed, traced, fault=fault, device=device)
    r.setup()
    st.mark("setup")
    if hasattr(r, "warmup"):
        r.warmup()
        st.mark("warmup")
    h0 = host_snapshot()
    t0 = r.window(seconds)
    print(host_line(h0, host_snapshot()), file=sys.stderr, flush=True)
    st.mark("window")
    setup_s = time.time() - (time.perf_counter() - t0) - t_proc
    result = {"attempted": r.attempted, "failed": r.failed,
              "device": device_info(1, peak_bytes())}
    if traced:
        ctx = r.layer_context()
        tr = ctx["trace"]
        if tr is None:
            raise RuntimeError("the window closed before its traced stretch began")
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
        result["metrics"] = per_layer(cell, ctx)
    else:
        result["metrics"] = r.end_to_end(setup_s)
    st.mark("metrics")
    r.free_program()
    checks = Checks(cell["limits"])
    for k, v in drv.Check(r).numbers().items():
        checks.add(k, v)
    st.mark("check")
    result["correct"] = checks.passed() and r.failed == 0
    return result, checks
