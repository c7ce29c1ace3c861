"""Image reading (PNG and JPEG), PNG writing and the JET colormap without
Pillow or OpenCV.

The CLIs and the data layer read and write images on machines that have
neither. A PNG is a signature plus zlib-compressed, per-row filtered
scanlines in length-prefixed, CRC-checked chunks, which `zlib` and
`struct` cover. A JPEG is decoded as libjpeg decodes it with its defaults,
which Pillow uses: the Huffman entropy decoder in Python (sequential and
progressive scans), then the integer "islow" inverse DCT, the fancy
(triangular) chroma upsampling and the fixed-point YCbCr -> RGB tables,
all vectorized in numpy over the blocks, so the result lands within 1 of
Pillow's per channel.
`read_image` / `image_size` pick the format from the file's signature."""

from __future__ import annotations

import re
import struct
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


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


def _scanlines(raw: bytes, h: int, w: int, ch: int, depth: int) -> np.ndarray:
    """h filtered scanlines of w pixels: (h, w, bytes a pixel) at depths 8
    and 16, (h, w, 1) sample values below 8 (packed most significant bit
    first, each row padded to a whole byte)."""
    bits = ch * depth
    rows = _unfilter(raw, h, -(-w * bits // 8), max(1, bits // 8))
    if depth >= 8:
        return rows.reshape(h, w, bits // 8)
    vals = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
    return (vals << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)[..., None]


def read_png(path: Path) -> np.ndarray:
    """Read a PNG of any colour type and bit depth, plain or
    Adam7-interlaced, as the array Pillow's `np.asarray(Image.open(path))`
    gives: uint8 (H, W), (H, W, 2), (H, W, 3) or (H, W, 4); 16-bit grey as
    uint16 (H, W) (Pillow's I;16), the other 16-bit types as the uint8 of
    each sample's high byte (Pillow's ;16B modes; grey + alpha as RGBA, grey
    repeated); grey at 1 bit as bool (mode 1), at 2 and 4 bits scaled to 0-255
    (L;2, L;4: x 85, x 17); a palette image (mode P) as its uint8 (H, W)
    index array, the palette unapplied."""
    data = Path(path).read_bytes()
    w, h, depth, ctype, interlace = _header(data, path)
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or interlace not in (0, 1):
        raise ValueError(f"{path}: not a valid PNG header (bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
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
    bpp = max(1, ch * depth // 8)  # bytes a pixel (sample values below 8 bits)
    raw = zlib.decompress(b"".join(idat))
    if interlace == 0:
        img = _scanlines(raw, h, w, ch, depth)
    else:
        img = np.zeros((h, w, bpp), np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue  # an empty pass has no scanlines
            n = ph * (-(-pw * ch * depth // 8) + 1)
            img[y0::dy, x0::dx] = _scanlines(raw[pos:pos + n], ph, pw, ch, depth)
            pos += n
    if depth < 8:
        img = img[..., 0]
        if ctype == 3:
            return img
        return img.astype(bool) if depth == 1 else img * np.uint8(255 // ((1 << depth) - 1))
    img = img.reshape(h, w, ch, depth // 8)
    if depth == 8:
        img = img[..., 0]
    elif ch == 1:
        img = img[..., 0].astype(np.uint16) << 8 | img[..., 1]
    else:
        img = img[..., 0]
        if ch == 2:  # Pillow opens 16-bit grey + alpha as RGBA
            img = img[..., [0, 0, 0, 1]]
    return img[..., 0] if ch == 1 else img


def read_image(path: Path) -> np.ndarray:
    """A PNG (`read_png`) or a JPEG (`read_jpeg`), by the file's signature."""
    with open(path, "rb") as fh:
        head = fh.read(8)
    if head == _SIGNATURE:
        return read_png(path)
    if head[:2] == b"\xff\xd8":
        return read_jpeg(path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


def image_size(path: Path) -> Tuple[int, int]:
    """(width, height) of a PNG or a JPEG, from its header."""
    with open(path, "rb") as fh:
        head = fh.read(8)
    if head == _SIGNATURE:
        return png_size(path)
    if head[:2] == b"\xff\xd8":
        frame = _jpeg_segments(Path(path).read_bytes(), path, frame_only=True)["frame"]
        return frame["width"], frame["height"]
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


# --- JPEG: Huffman-coded 8-bit, sequential or progressive (SOF0 / SOF1 / SOF2) ---------

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27,
    20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58,
    59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])  # zigzag index -> natural
_ZZ = _ZIGZAG.tolist()
_PROCESS = {3: "lossless", 5: "differential sequential", 6: "differential progressive",
            7: "differential lossless", 9: "arithmetic-coded sequential",
            10: "arithmetic-coded progressive", 11: "arithmetic-coded lossless",
            13: "arithmetic-coded differential sequential",
            14: "arithmetic-coded differential progressive",
            15: "arithmetic-coded differential lossless"}


def _jpeg_segments(data: bytes, path, frame_only: bool = False) -> dict:
    """The markers of a JPEG (or, with `frame_only`, those up to its frame
    header): quantization and Huffman tables, the restart interval, the
    frame, whether it is progressive, the JFIF and Adobe markers, and the
    scans with their spectral selection and successive approximation and
    their entropy-coded bytes."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    out = {"qt": {}, "ht": {}, "restart": 0, "frame": None, "scans": [], "adobe": None,
           "jfif": False, "progressive": False}
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{path}: corrupt JPEG (no marker at byte {pos})")
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker == 0xD9:  # EOI
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        seg = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker in (0xC0, 0xC1, 0xC2):  # baseline, extended sequential, progressive; Huffman
            prec, height, width, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise ValueError(f"{path}: {prec}-bit JPEG samples (12-bit JPEG is not read; "
                                 "only 8-bit)")
            comps = [dict(id=seg[6 + 3 * i], h=seg[7 + 3 * i] >> 4, v=seg[7 + 3 * i] & 15,
                          tq=seg[8 + 3 * i]) for i in range(nc)]
            out["frame"] = dict(width=width, height=height, comps=comps)
            out["progressive"] = marker == 0xC2
            if frame_only:
                return out
        elif 0xC3 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise ValueError(f"{path}: {_PROCESS[marker - 0xC0]} JPEG (SOF{marker - 0xC0}) is not "
                             "read (only Huffman-coded baseline, extended sequential and "
                             "progressive: SOF0 / SOF1 / SOF2)")
        elif marker == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(seg[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[_ZIGZAG] = vals
                out["qt"][tq] = table
                i += 1 + n
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                symbols = seg[i + 17:i + 17 + sum(counts)]
                out["ht"][(tc, th)] = _huffman_lut(counts, symbols)
                i += 17 + sum(counts)
        elif marker == 0xDD:  # DRI
            (out["restart"],) = struct.unpack(">H", seg[:2])
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            out["jfif"] = True
        elif marker == 0xEE and seg[:5] == b"Adobe":
            out["adobe"] = seg[11] if len(seg) > 11 else 0
        elif marker == 0xDA:  # SOS, then the entropy-coded data up to the next real marker
            if out["frame"] is None:
                raise ValueError(f"{path}: scan before the frame header")
            ns = seg[0]
            comps = [(seg[1 + 2 * i], seg[2 + 2 * i] >> 4, seg[2 + 2 * i] & 15) for i in range(ns)]
            ss, se, a = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            end = pos
            while True:
                end = data.find(b"\xff", end)
                if end < 0 or end + 1 >= len(data):
                    end = len(data)
                    break
                nxt = data[end + 1]
                if nxt == 0x00 or 0xD0 <= nxt <= 0xD7 or nxt == 0xFF:
                    end += 1 if nxt == 0xFF else 2
                    continue
                break
            out["scans"].append(dict(comps=comps, restart=out["restart"], ss=ss, se=se,
                                     ah=a >> 4, al=a & 15, tables=dict(out["ht"]),
                                     data=data[pos:end]))
            pos = end
    if out["frame"] is None:
        raise ValueError(f"{path}: no Huffman frame header (SOF0 / SOF1 / SOF2)")
    return out


def _huffman_lut(counts, symbols) -> Tuple[list, list]:
    """(code length, symbol) of every 16-bit window, by its leading code
    (length 0: no code starts so)."""
    lengths = np.zeros(1 << 16, np.int64)
    values = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for bits in range(1, 17):
        for _ in range(counts[bits - 1]):
            lo = code << (16 - bits)
            lengths[lo:lo + (1 << (16 - bits))] = bits
            values[lo:lo + (1 << (16 - bits))] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lengths.tolist(), values.tolist()


def _windows(segment: bytes) -> list:
    """The 16-bit window of the bit stream at every bit position, with the
    0xFF00 stuffing removed and 1-bits past the end."""
    b = np.frombuffer(segment.replace(b"\xff\x00", b"\xff") + b"\xff" * 8, np.uint8)
    n = 8 * (b.size - 8)
    trip = (b[:-2].astype(np.int64) << 16) | (b[1:-1].astype(np.int64) << 8) | b[2:]
    pos = np.arange(n + 17)
    return ((trip[pos >> 3] >> (8 - (pos & 7))) & 0xFFFF).tolist()


def _scan_kind(scan: dict, progressive: bool, path) -> str:
    """"sequential", or a progressive scan's kind ("dc_first", "dc_refine",
    "ac_first", "ac_refine") from its spectral selection (Ss, Se) and
    successive approximation (Ah, Al); malformed combinations raise."""
    if not progressive:
        return "sequential"
    ss, se = scan["ss"], scan["se"]
    if ss == 0:
        if se != 0:
            raise ValueError(f"{path}: corrupt progressive JPEG (a DC scan with Se {se})")
        return "dc_refine" if scan["ah"] else "dc_first"
    if se < ss or se > 63 or len(scan["comps"]) != 1:
        raise ValueError(f"{path}: corrupt progressive JPEG (an AC scan over bands {ss}-{se} "
                         f"of {len(scan['comps'])} components)")
    return "ac_refine" if scan["ah"] else "ac_first"


def _decode_scan(scan: dict, frame: dict, progressive: bool, path) -> None:
    """Huffman-decodes one scan into the coefficients of its components
    (component["coef"]: block x 64 + natural index -> the quantized value),
    as libjpeg's jdhuff.c (sequential) and jdphuff.c (progressive: DC first
    and refine, AC first with end-of-band runs, AC refine with its
    correction bits) decode them."""
    kind = _scan_kind(scan, progressive, path)
    by_id = {c["id"]: c for c in frame["comps"]}
    need_dc, need_ac = kind in ("sequential", "dc_first"), kind in ("sequential", "ac_first",
                                                                   "ac_refine")
    comps = []
    for cid, td, ta in scan["comps"]:
        if cid not in by_id or (need_dc and (0, td) not in scan["tables"]) \
                or (need_ac and (1, ta) not in scan["tables"]):
            raise ValueError(f"{path}: scan names a missing component or Huffman table")
        c = by_id[cid]
        comps.append(c)
        none = ([], [])
        c["decode"] = (*(scan["tables"][(0, td)] if need_dc else none),
                       *(scan["tables"][(1, ta)] if need_ac else none), c["coef"])
    # each unit (MCU) a list of its blocks: (component, first coefficient, tables, coefficients)
    if len(comps) == 1:  # non-interleaved: the component's own blocks in raster order
        c = comps[0]
        units = [[(0, (by * c["bw"] + bx) * 64, *c["decode"])]
                 for by in range(-(-c["height"] // 8)) for bx in range(-(-c["width"] // 8))]
    else:  # interleaved: MCUs of h x v blocks of each component
        units = [[(i, ((my * c["v"] + v) * c["bw"] + mx * c["h"] + h) * 64, *c["decode"])
                  for i, c in enumerate(comps) for v in range(c["v"]) for h in range(c["h"])]
                 for my in range(frame["mcuy"]) for mx in range(frame["mcux"])]
    interval = scan["restart"] or len(units)
    # the entropy-coded pieces between RSTn markers (a stuffed 0xFF is followed by 0x00)
    pieces = re.split(rb"\xff[\xd0-\xd7]", scan["data"])
    decode = {"sequential": _sequential, "dc_first": _dc_first, "dc_refine": _dc_refine,
              "ac_first": _ac_first, "ac_refine": _ac_refine}[kind]
    for s, start in enumerate(range(0, len(units), interval)):
        if s >= len(pieces):
            raise ValueError(f"{path}: corrupt JPEG (too few restart intervals)")
        win = _windows(pieces[s])
        # the DC predictions and the end-of-band run restart with each interval
        pos = decode(units[start:start + interval], win, scan, len(comps), path)
        if pos > len(win) - 17:
            raise ValueError(f"{path}: corrupt JPEG (the scan data ends early)")


def _bad_code(path):
    return ValueError(f"{path}: corrupt JPEG (bad Huffman code)")


def _sequential(units, win, scan, ncomp, path) -> int:
    """A baseline / extended-sequential interval: each block's DC difference
    and its run-length coded AC coefficients. Returns the bits read."""
    zz, pos, pred = _ZZ, 0, [0] * ncomp
    for unit in units:
        for i, base, dcl, dcs, acl, acs, coef in unit:
            w = win[pos]
            length = dcl[w]
            if length == 0:
                raise _bad_code(path)
            t = dcs[w]
            pos += length
            if t:
                v = win[pos] >> (16 - t)
                pos += t
                pred[i] += v if v >> (t - 1) else v - (1 << t) + 1
            coef[base] = pred[i]
            k = 1
            while k < 64:
                w = win[pos]
                length = acl[w]
                if length == 0:
                    raise _bad_code(path)
                rs = acs[w]
                pos += length
                t = rs & 15
                if t == 0:
                    if rs != 0xF0:
                        break  # end of block
                    k += 16
                    continue
                k += rs >> 4
                v = win[pos] >> (16 - t)
                pos += t
                coef[base + zz[k]] = v if v >> (t - 1) else v - (1 << t) + 1
                k += 1
    return pos


def _dc_first(units, win, scan, ncomp, path) -> int:
    """A progressive DC first scan: the DC difference, the coefficient set
    to the prediction shifted left by Al."""
    pos, pred, al = 0, [0] * ncomp, scan["al"]
    for unit in units:
        for i, base, dcl, dcs, _, _, coef in unit:
            w = win[pos]
            length = dcl[w]
            if length == 0:
                raise _bad_code(path)
            t = dcs[w]
            pos += length
            if t:
                v = win[pos] >> (16 - t)
                pos += t
                pred[i] += v if v >> (t - 1) else v - (1 << t) + 1
            coef[base] = pred[i] << al
    return pos


def _dc_refine(units, win, scan, ncomp, path) -> int:
    """A progressive DC refinement scan: one raw bit a block, OR-ed in at Al."""
    pos, p1 = 0, 1 << scan["al"]
    for unit in units:
        for _, base, _, _, _, _, coef in unit:
            if win[pos] >> 15:
                coef[base] |= p1
            pos += 1
    return pos


def _ac_first(units, win, scan, ncomp, path) -> int:
    """A progressive AC first scan over bands [Ss, Se] of one component:
    run-length coded values shifted left by Al, ZRL, and end-of-band runs
    (EOBr: 2^r + r appended bits blocks whose band is all zero)."""
    zz, pos, eobrun = _ZZ, 0, 0
    ss, se, al = scan["ss"], scan["se"], scan["al"]
    for unit in units:
        _, base, _, _, acl, acs, coef = unit[0]
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            w = win[pos]
            length = acl[w]
            if length == 0:
                raise _bad_code(path)
            rs = acs[w]
            pos += length
            r, t = rs >> 4, rs & 15
            if t:
                k += r
                if k > se:
                    raise ValueError(f"{path}: corrupt JPEG (a run past the band)")
                v = win[pos] >> (16 - t)
                pos += t
                coef[base + zz[k]] = (v if v >> (t - 1) else v - (1 << t) + 1) << al
                k += 1
            elif r == 15:
                k += 16
            else:
                eobrun = (1 << r) - 1  # this block's band ends here
                if r:
                    eobrun += win[pos] >> (16 - r)
                    pos += r
                break
    return pos


def _ac_refine(units, win, scan, ncomp, path) -> int:
    """A progressive AC refinement scan over bands [Ss, Se] of one
    component, as libjpeg's decode_mcu_AC_refine: each newly nonzero
    coefficient (+-2^Al, its sign a raw bit) after r zero ones, a correction
    bit for every already-nonzero coefficient passed (1: its magnitude grows
    by 2^Al), and end-of-band runs whose blocks take correction bits only."""
    zz, pos, eobrun = _ZZ, 0, 0
    ss, se = scan["ss"], scan["se"]
    p1, m1 = 1 << scan["al"], -1 << scan["al"]
    for unit in units:
        _, base, _, _, acl, acs, coef = unit[0]
        k = ss
        if eobrun == 0:
            while k <= se:
                w = win[pos]
                length = acl[w]
                if length == 0:
                    raise _bad_code(path)
                rs = acs[w]
                pos += length
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if win[pos] >> 15 else m1
                    pos += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += win[pos] >> (16 - r)
                        pos += r
                    break  # the rest of the band: the end-of-band pass below
                # pass the nonzero coefficients (a correction bit each) and r zero ones
                while k <= se:
                    z = base + zz[k]
                    if coef[z]:
                        if win[pos] >> 15 and not coef[z] & p1:
                            coef[z] += p1 if coef[z] >= 0 else m1
                        pos += 1
                    else:
                        if r == 0:
                            break  # the zero coefficient that becomes nonzero
                        r -= 1
                    k += 1
                if s:
                    if k > se:
                        raise ValueError(f"{path}: corrupt JPEG (a run past the band)")
                    coef[base + zz[k]] = s
                k += 1
        if eobrun:
            while k <= se:
                z = base + zz[k]
                if coef[z]:
                    if win[pos] >> 15 and not coef[z] & p1:
                        coef[z] += p1 if coef[z] >= 0 else m1
                    pos += 1
                k += 1
            eobrun -= 1
    return pos


# libjpeg's jidctint.c (jpeg_idct_islow): 13-bit fixed-point constants
_F = dict(f0_298=2446, f0_390=3196, f0_541=4433, f0_765=6270, f0_899=7373, f1_175=9633,
          f1_501=12299, f1_847=15137, f1_961=16069, f2_053=16819, f2_562=20995, f3_072=25172)


def _idct_1d(x: np.ndarray, shift: int) -> np.ndarray:
    """One pass of jpeg_idct_islow over axis -1 of int64 x (..., 8), each
    output descaled by `shift` bits with rounding (libjpeg's DESCALE)."""
    f = _F
    z1 = (x[..., 2] + x[..., 6]) * f["f0_541"]
    tmp2 = z1 - x[..., 6] * f["f1_847"]
    tmp3 = z1 + x[..., 2] * f["f0_765"]
    tmp0 = (x[..., 0] + x[..., 4]) << 13
    tmp1 = (x[..., 0] - x[..., 4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * f["f1_175"]
    o0, o1, o2, o3 = o0 * f["f0_298"], o1 * f["f2_053"], o2 * f["f3_072"], o3 * f["f1_501"]
    z1, z2 = z1 * -f["f0_899"], z2 * -f["f2_562"]
    z3, z4 = z3 * -f["f1_961"] + z5, z4 * -f["f0_390"] + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    half = 1 << (shift - 1)
    out = [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3]
    return (np.stack(out, -1) + half) >> shift


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """(..., 8, 8) dequantized coefficients (row v, column u) -> uint8
    samples, as jpeg_idct_islow computes them: columns first (descale by
    CONST_BITS - PASS1_BITS = 11), then rows (by CONST_BITS + PASS1_BITS +
    3 = 18), plus 128, clamped."""
    cols = _idct_1d(np.swapaxes(coef, -1, -2), 11)  # (..., u, y)
    rows = _idct_1d(np.swapaxes(cols, -1, -2), 18)  # (..., y, x)
    return np.clip(rows + 128, 0, 255).astype(np.uint8)


def _fancy_h2(x: np.ndarray, bias_left: int, bias_right: int, shift: int) -> np.ndarray:
    """libjpeg's fancy horizontal upsampling by 2 of int64 rows x (H, W):
    out[2i] = (3 x[i] + x[i-1] + bias_left) >> shift and out[2i+1] = (3 x[i]
    + x[i+1] + bias_right) >> shift, the edge columns 4 x with their bias."""
    h, w = x.shape
    out = np.empty((h, 2 * w), np.int64)
    out[:, 0] = (4 * x[:, 0] + bias_left) >> shift
    out[:, 2::2] = (3 * x[:, 1:] + x[:, :-1] + bias_left) >> shift
    out[:, 1:-1:2] = (3 * x[:, :-1] + x[:, 1:] + bias_right) >> shift
    out[:, -1] = (4 * x[:, -1] + bias_right) >> shift
    return out


def _upsample(plane: np.ndarray, h: int, v: int, path) -> np.ndarray:
    """A chroma plane (its true downsampled size) brought to full size by
    libjpeg's h2v1 / h2v2 fancy upsampling (triangular filters; the rows
    above the first and below the last repeat them)."""
    x = plane.astype(np.int64)
    if (h, v) == (1, 1):
        return x
    if x.shape[1] <= 2:
        raise ValueError(f"{path}: chroma planes of width <= 2 are not read")
    if (h, v) == (2, 1):  # h2v1_fancy_upsample: 3/4 nearer + 1/4 further
        return _fancy_h2(x, 1, 2, 2)
    if (h, v) == (2, 2):  # h2v2_fancy_upsample: 9/16, 3/16, 3/16, 1/16
        out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int64)
        out[0::2] = _fancy_h2(3 * x + np.concatenate([x[:1], x[:-1]]), 8, 7, 4)
        out[1::2] = _fancy_h2(3 * x + np.concatenate([x[1:], x[-1:]]), 8, 7, 4)
        return out
    raise ValueError(f"{path}: chroma sampling {h}x{v} is not read (4:4:4, 4:2:2, 4:2:0 are)")


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """libjpeg's ycc_rgb_convert with its 16-bit fixed-point tables."""
    def fix(v):
        return int(v * 65536 + 0.5)

    half = 1 << 15
    cb, cr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * cr + half) >> 16)
    g = y + ((-fix(0.34414) * cb + half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _colour_space(seg: dict, path) -> str:
    """The components' colour space as libjpeg reads it: grey; for three,
    YCbCr under a JFIF marker, else RGB under an Adobe marker with
    transform 0 (or, with neither, component ids 'R', 'G', 'B'), else
    YCbCr; for four, YCCK under an Adobe marker with a transform other than
    0, else CMYK."""
    comps = seg["frame"]["comps"]
    if len(comps) == 1:
        return "grey"
    if len(comps) == 3:
        if seg["jfif"]:
            return "ycbcr"
        if seg["adobe"] is not None:
            return "rgb" if seg["adobe"] == 0 else "ycbcr"
        return "rgb" if [c["id"] for c in comps] == [82, 71, 66] else "ycbcr"
    if len(comps) == 4:
        return "cmyk" if seg["adobe"] in (None, 0) else "ycck"
    raise ValueError(f"{path}: {len(comps)}-component JPEGs are not read (1, 3 or 4 are)")


def read_jpeg(path: Path) -> np.ndarray:
    """Read an 8-bit Huffman-coded JPEG, baseline, extended sequential or
    progressive (SOF0 / SOF1 / SOF2), with any sampling factors the
    upsampler takes (4:4:4, 4:2:2, 4:2:0), restart intervals and any size,
    as Pillow's `np.asarray(Image.open(path))` gives it to within 1 per
    channel: uint8 (H, W) grey, (H, W, 3) RGB (YCbCr converted, Adobe RGB
    as stored), or (H, W, 4) for four components, which Pillow opens as
    CMYK with Adobe's inverted polarity: 255 - each stored plane (CMYK), or
    the RGB of the first three and 255 - K (YCCK). Lossless, differential,
    arithmetic-coded and 12-bit files raise, naming the process."""
    data = Path(path).read_bytes()
    seg = _jpeg_segments(data, path)
    frame = seg["frame"]
    comps = frame["comps"]
    space = _colour_space(seg, path)
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    width, height = frame["width"], frame["height"]
    frame["mcux"] = -(-width // (8 * hmax))
    frame["mcuy"] = -(-height // (8 * vmax))
    for c in comps:
        c["bw"], c["bh"] = frame["mcux"] * c["h"], frame["mcuy"] * c["v"]
        c["width"], c["height"] = -(-width * c["h"] // hmax), -(-height * c["v"] // vmax)
        c["coef"] = [0] * (c["bw"] * c["bh"] * 64)
        if c["tq"] not in seg["qt"]:
            raise ValueError(f"{path}: missing quantization table {c['tq']}")
    if not seg["scans"]:
        raise ValueError(f"{path}: no scan")
    for scan in seg["scans"]:
        _decode_scan(scan, frame, seg["progressive"], path)
    planes = []
    for c in comps:
        coef = np.asarray(c["coef"], np.int64).reshape(c["bh"], c["bw"], 8, 8)
        pix = _idct_islow(coef * seg["qt"][c["tq"]].reshape(8, 8))
        pix = pix.transpose(0, 2, 1, 3).reshape(8 * c["bh"], 8 * c["bw"])
        planes.append((pix[:c["height"], :c["width"]], hmax // c["h"], vmax // c["v"]))
    if space == "grey":
        return np.ascontiguousarray(planes[0][0][:height, :width])
    full = [_upsample(p, h, v, path)[:height, :width] for p, h, v in planes]
    if space == "rgb":
        return np.stack(full, -1).astype(np.uint8)
    if space == "cmyk":
        return (255 - np.stack(full, -1)).astype(np.uint8)
    rgb = _ycc_to_rgb(*full[:3])
    if space == "ycbcr":
        return rgb
    return np.concatenate([rgb, (255 - full[3]).astype(np.uint8)[..., None]], -1)  # ycck


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
