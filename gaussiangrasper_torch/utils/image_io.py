"""PNG writing and the JET colormap without Pillow or OpenCV.

The serving CLIs write PNGs on machines that have neither; a PNG is a
signature plus zlib-compressed scanlines in length-prefixed, CRC-checked
chunks, which `zlib` and `struct` cover."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: Path, img: np.ndarray) -> None:
    """Write an 8-bit (H, W) grayscale or (H, W, 3) RGB image."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"want uint8 (H, W) or (H, W, 3), got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color_type = 0 if img.ndim == 2 else 2
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()  # filter 0
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                           + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def jet(v: np.ndarray) -> np.ndarray:
    """JET colormap of values in [0, 1] -> uint8 RGB (..., 3): the
    piecewise-linear blue-cyan-yellow-red ramp OpenCV's COLORMAP_JET uses."""
    v = np.clip(np.asarray(v, np.float32), 0.0, 1.0)[..., None]
    centre = np.array([3.0, 2.0, 1.0], np.float32)  # r, g, b
    rgb = np.clip(1.5 - np.abs(4.0 * v - centre), 0.0, 1.0)
    return (rgb * 255.0).astype(np.uint8)


def depth2color(depth: np.ndarray) -> np.ndarray:
    """JET colormap on min-max normalized depth."""
    d = depth - depth.min()
    return jet(d / (d.max() + 1e-8))
