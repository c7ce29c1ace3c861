"""Build the CUDA kernels in csrc/ with nvcc and load them through ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first use
into `build/lib<name>.so` beside this package (a directory git ignores):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v
         -shared -Xcompiler -fPIC -o build/lib<name>.so csrc/<name>.cu

No `--use_fast_math`: `__expf` changes the kernels' cut decisions and the
alpha-cutoff test against their plain PyTorch versions. A library is rebuilt
when its source is newer. Nothing here runs at import: a machine without
nvcc or a GPU imports the package and uses the plain versions on CPU
tensors. `build_all` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def kernel_sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _paths(name: str):
    return CSRC / f"{name}.cu", BUILD / f"lib{name}.so", BUILD / f"{name}.ptxas.txt"


def _stale(name: str) -> bool:
    src, lib, _ = _paths(name)
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def _start(name: str) -> subprocess.Popen:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin")
    src, lib, _ = _paths(name)
    BUILD.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
           "-o", str(lib), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    _paths(name)[2].write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{out}")


def build_all() -> Dict[str, str]:
    """Compile every stale source in parallel; returns each kernel's
    `-Xptxas -v` report (registers, shared memory, spills)."""
    procs = {name: _start(name) for name in kernel_sources() if _stale(name)}
    for name, proc in procs.items():
        _finish(name, proc)
    return {name: _paths(name)[2].read_text() for name in kernel_sources()
            if _paths(name)[2].exists()}


def load_library(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, compiling it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            if _stale(name):
                _finish(name, _start(name))
            lib = ctypes.CDLL(str(_paths(name)[1]))
            _loaded[name] = lib
        return lib
