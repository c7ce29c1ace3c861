"""PNG reading and writing and the JET colormap without Pillow or OpenCV.

The CLIs and the data layer read and write PNGs on machines that have
neither; a PNG is a signature plus zlib-compressed, per-row filtered
scanlines in length-prefixed, CRC-checked chunks, which `zlib` and
`struct` cover."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _header(data: bytes, path) -> Tuple[int, int, int, int, int]:
    """(width, height, bit depth, colour type, interlace) from the IHDR chunk."""
    if data[:8] != _SIGNATURE or data[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", data[16:29])
    return w, h, depth, ctype, interlace


def png_size(path: Path) -> Tuple[int, int]:
    """(width, height) of a PNG, from its header alone."""
    with open(path, "rb") as fh:
        w, h, *_ = _header(fh.read(29), path)
    return w, h


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth).
    None, Sub and Up run vectorized; Average and Paeth walk the row's bytes."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, want {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            cur = (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0) % 256)
            cur = cur.astype(np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prior
        elif kind in (3, 4):
            cur = bytearray(stride)
            up = prior.tolist()
            for x, v in enumerate(line.tolist()):
                a = cur[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (a + up[x]) >> 1
                else:
                    pred = _paeth(a, up[x], up[x - bpp] if x >= bpp else 0)
                cur[x] = (v + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG filter type {kind} is not one of 0-4")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: Path) -> np.ndarray:
    """Read an 8-bit, non-interlaced grey, grey + alpha, RGB or RGBA PNG as
    uint8 (H, W), (H, W, 2), (H, W, 3) or (H, W, 4), the arrays Pillow's
    `np.asarray(Image.open(path))` gives. Anything else raises."""
    data = Path(path).read_bytes()
    w, h, depth, ctype, interlace = _header(data, path)
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey / grey+alpha / RGB / RGBA PNGs "
                         f"are read (bit depth {depth}, colour type {ctype}, interlace {interlace})")
    idat, pos = [], 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        elif kind == b"IEND":
            break
        pos += 12 + length
    ch = _CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)


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
    Path(path).write_bytes(_SIGNATURE + _chunk(b"IHDR", ihdr)
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
