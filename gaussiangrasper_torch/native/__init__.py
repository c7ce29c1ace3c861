"""Native (C++) host sampler, loaded through ctypes (the JAX package's
native/ loader, building into the port's build directory).

`sampling.cpp` is compiled on first use with g++ into
`gaussiangrasper_torch/build/libsampling.so` (a directory git ignores),
never into the package directory. A host with no g++ gets None from
`sample_mask_batch`, and the datamanager runs its numpy branch instead: this
is host sampling, not device work. `branch()` says which one runs.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "sampling.cpp"
BUILD = Path(__file__).resolve().parent.parent / "build"
LIB_PATH = BUILD / "libsampling.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _build() -> bool:
    """g++ into a temporary file, then an atomic rename, so processes that
    build at once never load a half-written library."""
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, str(_SRC)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> Optional[ctypes.CDLL]:
    """The sampler library, built if missing or older than its source;
    None when it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        stale = not LIB_PATH.exists() or LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime
        if stale and not _build():
            return None
        try:
            lib = ctypes.CDLL(str(LIB_PATH))
        except OSError:
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.sample_mask_batch.restype = ctypes.c_int32
        lib.sample_mask_batch.argtypes = [
            i32p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64,
            i32p, i32p, u8p, u8p, i32p, u8p,
        ]
        _lib = lib
        return _lib


def branch() -> str:
    """"native" when the C++ sampler loads on this host, else "numpy"."""
    return "native" if load() is not None else "numpy"


def sample_mask_batch(
    mask: np.ndarray, g: int, p: int, s: int, seed: int
) -> Optional[Tuple[np.ndarray, ...]]:
    """The datamanager's per-step sampling in one C++ pass. Returns
    (pair_a, pair_b, pair_valid, group_valid, points, point_valid), or None
    when the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    mask = np.ascontiguousarray(mask, np.int32)
    h, w = mask.shape
    pair_a = np.zeros((g, p, 2), np.int32)
    pair_b = np.zeros((g, p, 2), np.int32)
    pair_valid = np.zeros((g, p), np.uint8)
    group_valid = np.zeros((g,), np.uint8)
    points = np.zeros((s, 2), np.int32)
    point_valid = np.zeros((s,), np.uint8)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.sample_mask_batch(
        ptr(mask, ctypes.c_int32), h, w, g, p, s,
        ctypes.c_uint64(seed or 1),
        ptr(pair_a, ctypes.c_int32), ptr(pair_b, ctypes.c_int32),
        ptr(pair_valid, ctypes.c_uint8), ptr(group_valid, ctypes.c_uint8),
        ptr(points, ctypes.c_int32), ptr(point_valid, ctypes.c_uint8),
    )
    return (
        pair_a, pair_b, pair_valid.astype(bool), group_valid.astype(bool),
        points, point_valid.astype(bool),
    )
