"""Build the CUDA kernels in csrc/ with nvcc and load them through ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first use
into `build/lib<name>.so` beside this package (a directory git ignores):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v
         -shared -Xcompiler -fPIC -o build/lib<name>.so csrc/<name>.cu

No `--use_fast_math`: `__expf` changes the kernels' cut decisions and the
alpha-cutoff test against their plain PyTorch versions. A library is rebuilt
when its source, or a csrc/ header the source includes, is newer. Nothing here runs at
import: a machine without nvcc or a GPU imports the package and uses the
plain versions on CPU tensors. `build_all` starts one nvcc per source, all
at once. `entry` binds one C entry point of a built library, and `launch`
calls one that launches a kernel: every kernel launch of the port goes
through it and is counted in `launches`.
"""

from __future__ import annotations

import collections
import ctypes
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

_loaded: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, Tuple[ctypes.CDLL, object]] = {}
_lock = threading.Lock()

launches: collections.Counter = collections.Counter()
"""Kernel launches made through `launch`, by C entry name (for example
`ggt_composite_pairs_fwd2`). `launches.clear()` sets every count to 0."""
_count_lock = threading.Lock()  # autograd's backward launches from its own thread


def kernel_sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _paths(name: str):
    return CSRC / f"{name}.cu", BUILD / f"lib{name}.so", BUILD / f"{name}.ptxas.txt"


def _stale(name: str) -> bool:
    src, lib, _ = _paths(name)
    headers = [CSRC / h for h in re.findall(r'#include "(\w+\.cuh)"', src.read_text())]
    newest = max(p.stat().st_mtime for p in [src, *headers])
    return not lib.exists() or lib.stat().st_mtime < newest


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
            lib.ggt_cuda_error_string.restype = ctypes.c_char_p
            lib.ggt_cuda_error_string.argtypes = [ctypes.c_int]
            _loaded[name] = lib
        return lib


def entry(source: str, name: str, argtypes: Sequence):
    """(library, C entry `name` of csrc/<source>.cu), built, loaded and
    bound on first use; later calls return the same pair. Every entry
    returns a CUDA error code (0 is success), which `check_error` turns
    into an exception."""
    bound = _entries.get(name)
    if bound is None:
        lib = load_library(source)
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        bound = _entries[name] = (lib, fn)
    return bound


def check_error(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: " + lib.ggt_cuda_error_string(err).decode())


def launch(source: str, name: str, argtypes: Sequence, *args, device: torch.device) -> None:
    """Launch the kernel behind C entry `name` of csrc/<source>.cu: `args`
    (of `argtypes`), then the current CUDA stream of `device`, which the
    entry takes last. Raises RuntimeError on a nonzero return and counts
    the launch in `launches[name]`."""
    lib, fn = _entries.get(name) or entry(source, name, [*argtypes, ctypes.c_void_p])
    check_error(lib, fn(*args, torch.cuda.current_stream(device).cuda_stream), f"{name} launch")
    with _count_lock:
        launches[name] += 1
