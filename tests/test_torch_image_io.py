"""PyTorch port vs Pillow and the JAX package: frames that are not 8-bit
plain PNGs.

- JPEG: files that Pillow writes (grey; YCbCr at 4:4:4, 4:2:2 and 4:2:0;
  a restart interval; optimized Huffman tables; an SOF1 header; sizes that
  are and are not multiples of the MCU) decode to Pillow's array within 1
  per channel (libjpeg's islow IDCT, fancy upsampling and colour tables);
  so do progressive JPEGs, and CMYK (Adobe polarity), YCCK and RGB-stored
  ones, whose frames also load as the JAX dataset loads them; lossless,
  differential, arithmetic-coded and 12-bit JPEGs raise naming the process.
- PNG: Adam7-interlaced, 16-bit, palette and 1 / 2 / 4-bit grey files load
  to exactly the arrays of the JAX dataset's `load_image` (Pillow
  underneath: 16-bit grey as uint16, other 16-bit types as their high
  bytes, a palette image as its indices, 1-bit grey as bool).
- A JPEG capture (the tabletop's frames re-saved as JPEG, no w / h in
  transforms.json) through both packages' nerfstudio parsers and datasets:
  the same parsed cameras, the frames within 1/255.
"""

import json
import struct
import types
import zlib

import numpy as np
import pytest
from PIL import Image

from gaussiangrasper_torch.data.dataparsers.zoo import resolve_parser as t_resolve
from gaussiangrasper_torch.data.dataset import InputDataset as TDataset
from gaussiangrasper_torch.utils.image_io import image_size, read_image, read_jpeg, read_png
from gaussiangrasper_tpu.data.dataparsers.zoo import resolve_parser as j_resolve
from gaussiangrasper_tpu.data.dataset import InputDataset as JDataset
from gaussiangrasper_tpu.data.synthetic import generate_tabletop
from tests.test_torch_data import _assert_outputs_equal, _paeth

JPEG_CASES = {
    "grey": ("L", dict()),
    "444": ("RGB", dict(subsampling=0)),
    "422": ("RGB", dict(subsampling=1)),
    "420": ("RGB", dict(subsampling=2)),
    "420_restart": ("RGB", dict(subsampling=2, restart_marker_blocks=3)),
    "grey_restart_rows": ("L", dict(restart_marker_rows=1)),
    "422_optimized": ("RGB", dict(subsampling=1, optimize=True)),
    "420_sof1": ("RGB", dict(subsampling=2)),
}


def smooth_noisy(h, w, ch, seed):
    """Smooth colour ramps with noise: every DCT band and the chroma do work."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 5.0 + k) * np.cos(y / 7.0 - k) for k in range(ch)], -1)
    return np.clip(img + rng.normal(0, 20, img.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("size", [(37, 23), (64, 48)])
@pytest.mark.parametrize("case", list(JPEG_CASES))
def test_jpeg_decodes_within_one_of_pillow(case, size, tmp_path):
    mode, kw = JPEG_CASES[case]
    w, h = size
    img = smooth_noisy(h, w, 1 if mode == "L" else 3, seed=len(case) + w)
    path = tmp_path / "f.jpg"
    for quality in (60, 95):
        Image.fromarray(img[..., 0] if mode == "L" else img, mode).save(path, "JPEG",
                                                                         quality=quality, **kw)
        if case.endswith("sof1"):  # extended sequential: the same Huffman coding, marker C1
            data = path.read_bytes()
            assert data.count(b"\xff\xc0") == 1
            path.write_bytes(data.replace(b"\xff\xc0", b"\xff\xc1"))
        want = np.asarray(Image.open(path))
        got = read_jpeg(path)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert int(np.abs(got.astype(np.int64) - want).max()) <= 1, (case, quality)
        np.testing.assert_array_equal(read_image(path), got)
        assert image_size(path) == (w, h)


PROGRESSIVE_CASES = ("grey", "444", "422", "420", "420_restart", "grey_restart_rows",
                     "422_optimized")


@pytest.mark.parametrize("size", [(37, 23), (64, 48)])
@pytest.mark.parametrize("case", PROGRESSIVE_CASES)
def test_progressive_jpeg_decodes_within_one_of_pillow(case, size, tmp_path):
    """Progressive JPEGs as Pillow writes them (spectral selection and
    successive approximation: DC first and refine, AC first with
    end-of-band runs, AC refine), at two qualities."""
    mode, kw = JPEG_CASES[case]
    w, h = size
    img = smooth_noisy(h, w, 1 if mode == "L" else 3, seed=len(case) + w + 1)
    path = tmp_path / "p.jpg"
    for quality in (60, 95):
        Image.fromarray(img[..., 0] if mode == "L" else img, mode).save(
            path, "JPEG", quality=quality, progressive=True, **kw)
        assert b"\xff\xc2" in path.read_bytes()
        want = np.asarray(Image.open(path))
        got = read_jpeg(path)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert int(np.abs(got.astype(np.int64) - want).max()) <= 1, (case, quality)
        np.testing.assert_array_equal(read_image(path), got)
        assert image_size(path) == (w, h)


def _segment_at(data: bytes, marker: int) -> int:
    """Byte offset of the first segment with this marker."""
    pos = 2
    while data[pos + 1] != marker:
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    return pos


def _colour_variant(path, variant):
    """A JPEG that Pillow wrote, re-marked: "ycck", its Adobe transform set
    to 2 (four components, stored as YCCK); "adobe_rgb", its JFIF marker
    replaced by an Adobe one with transform 0 (three components stored as
    RGB); "rgb_ids", the JFIF marker dropped and the component ids set to
    'R', 'G', 'B' (stored as RGB, by libjpeg's guess)."""
    data = bytearray(path.read_bytes())
    if variant == "ycck":
        data[data.find(b"Adobe") + 11] = 2
    elif variant in ("adobe_rgb", "rgb_ids"):
        app0 = _segment_at(data, 0xE0)
        assert data[app0 + 4:app0 + 9] == b"JFIF\x00"
        end = app0 + 2 + struct.unpack(">H", data[app0 + 2:app0 + 4])[0]
        adobe = b"\xff\xee" + struct.pack(">H", 14) + b"Adobe\x00\x64" + b"\x00" * 5
        data[app0:end] = adobe if variant == "adobe_rgb" else b""
        if variant == "rgb_ids":
            sof, sos = _segment_at(data, 0xC0), _segment_at(data, 0xDA)
            for i, cid in enumerate((82, 71, 66)):
                data[sof + 4 + 6 + 3 * i] = cid
                data[sos + 4 + 1 + 2 * i] = cid
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("variant", ["cmyk", "cmyk_progressive", "ycck", "adobe_rgb", "rgb_ids"])
def test_cmyk_and_rgb_jpegs_load_as_in_jax(variant, tmp_path):
    """Four-component JPEGs (Pillow's CMYK, the same re-marked as YCCK) and
    three-component ones stored as RGB: read_jpeg within 1 of Pillow's array
    (CMYK: Adobe's inverted polarity), and the port's dataset within 1/255
    of the JAX dataset's `load_image` (which composites the fourth channel
    of a CMYK array as alpha over white)."""
    path = tmp_path / "c.jpg"
    if variant in ("adobe_rgb", "rgb_ids"):
        Image.fromarray(smooth_noisy(29, 37, 3, seed=6)).save(path, "JPEG", quality=90,
                                                              subsampling=0)
    else:
        Image.fromarray(smooth_noisy(29, 37, 4, seed=5), "CMYK").save(
            path, "JPEG", quality=90, progressive=variant == "cmyk_progressive")
    _colour_variant(path, variant)
    pil = Image.open(path)
    assert pil.mode == ("RGB" if variant in ("adobe_rgb", "rgb_ids") else "CMYK")
    want = np.asarray(pil)
    got = read_jpeg(path)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert int(np.abs(got.astype(np.int64) - want).max()) <= 1
    t_img, j_img = load_both(path)
    assert t_img.shape == j_img.shape == (29, 37, 3) and t_img.dtype == j_img.dtype
    assert float(np.abs(t_img - j_img).max()) <= 1.0 / 255.0 + 1e-7


@pytest.mark.parametrize("process", ["lossless", "arithmetic", "arithmetic_progressive",
                                     "differential", "12_bit"])
def test_other_jpeg_processes_raise_naming_them(process, tmp_path):
    """F2c: the processes no file here can be made for (Pillow writes none
    of them) raise with the process named: a baseline file re-marked SOF3,
    SOF9, SOF10, SOF5, or at 12-bit precision. A file that is neither PNG
    nor JPEG raises."""
    path = tmp_path / "x.jpg"
    Image.fromarray(smooth_noisy(16, 16, 3, 0)).save(path, "JPEG")
    data = bytearray(path.read_bytes())
    sof = _segment_at(data, 0xC0)
    if process == "12_bit":
        data[sof + 4] = 12
    else:
        data[sof + 1] = {"lossless": 0xC3, "arithmetic": 0xC9, "arithmetic_progressive": 0xCA,
                         "differential": 0xC5}[process]
    path.write_bytes(bytes(data))
    match = {"lossless": "lossless JPEG \\(SOF3\\)", "arithmetic": "arithmetic-coded sequential",
             "arithmetic_progressive": "arithmetic-coded progressive",
             "differential": "differential sequential", "12_bit": "12-bit JPEG"}[process]
    for fn in (read_jpeg, read_image, image_size):
        with pytest.raises(ValueError, match=match):
            fn(path)
    (tmp_path / "x.gif").write_bytes(b"GIF89a....")
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        read_image(tmp_path / "x.gif")


def encode_png(img: np.ndarray, depth: int, interlace: bool, palette=None) -> bytes:
    """A PNG of uint8 (depth <= 8) or uint16 (depth 16) samples, plain or
    Adam7-interlaced, each scanline with filter type (row + pass) % 5;
    below 8 bits the samples packed most significant bit first; with a
    `palette` ((n, 3) uint8), a palette image of the indices in img."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    bpp = max(1, ch * depth // 8)

    def row_bytes(sub):  # (rows, cols[, ch]) samples -> (rows, bytes) of packed scanlines
        if depth == 16:
            return sub.astype(">u2").view(np.uint8).reshape(sub.shape[0], -1)
        if depth == 8:
            return sub.astype(np.uint8).reshape(sub.shape[0], -1)
        bits = (sub[..., None] >> np.arange(depth - 1, -1, -1)) & 1
        return np.packbits(bits.reshape(sub.shape[0], -1).astype(np.uint8), axis=1)

    passes = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
              (0, 1, 1, 2)] if interlace else [(0, 0, 1, 1)]
    out = bytearray()
    for p, (x0, y0, dx, dy) in enumerate(passes):
        sub = img[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        sub = row_bytes(sub).astype(np.int64)
        prior = np.zeros(sub.shape[1], np.int64)
        for y, x in enumerate(sub):
            a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
            c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
            kind = (y + p) % 5
            pred = [0, a, prior, (a + prior) // 2, _paeth(a, prior, c)][kind]
            out += bytes([kind]) + ((x - pred) % 256).astype(np.uint8).tobytes()
            prior = x

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))
    plte = chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()) if palette is not None else b""
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + plte
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


def load_both(path):
    outputs = types.SimpleNamespace(image_filenames=[path])
    return TDataset(outputs).load_image(0), JDataset(outputs).load_image(0)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("depth,interlace", [(8, True), (16, False), (16, True)])
def test_interlaced_and_16_bit_png_match_pillow_and_jax(channels, depth, interlace, tmp_path):
    """(Plain 8-bit PNGs: tests/test_torch_data.py.)"""
    rng = np.random.default_rng(channels * depth + interlace)
    shape = (13, 11) if channels == 1 else (13, 11, channels)  # every Adam7 pass non-empty
    img = rng.integers(0, 1 << depth, shape).astype(np.uint16 if depth == 16 else np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(encode_png(img, depth, interlace))
    got, want = read_png(path), np.asarray(Image.open(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if depth == 16:  # grey keeps its 16 bits, the other types their high bytes
        high = (img >> 8).astype(np.uint8)
        np.testing.assert_array_equal(got, {1: img, 2: high[..., [0, 0, 0, 1]]}.get(channels, high))
    if channels != 2 or depth == 16:  # the JAX dataset passes 8-bit grey + alpha through as two
        t_img, j_img = load_both(path)  # channels
        assert t_img.dtype == j_img.dtype == np.float32
        np.testing.assert_array_equal(t_img, j_img)


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("kind,depth", [("palette", 1), ("palette", 2), ("palette", 4),
                                        ("palette", 8), ("grey", 1), ("grey", 2), ("grey", 4)])
def test_palette_and_sub_8_bit_png_load_as_in_jax(kind, depth, interlace, tmp_path):
    """Palette PNGs load as the JAX dataset loads them: Pillow's mode P
    array is the index array, which `load_image` takes as grey / 255 (the
    palette unapplied). Grey below 8 bits: Pillow's array (bool at 1 bit,
    x 85 / x 17 at 2 / 4 bits), then `load_image` (1 bit: 0 or 1/255)."""
    rng = np.random.default_rng(depth + 10 * interlace)
    img = rng.integers(0, 1 << depth, (13, 11)).astype(np.uint8)
    palette = rng.integers(0, 256, (1 << depth, 3)) if kind == "palette" else None
    path = tmp_path / "f.png"
    path.write_bytes(encode_png(img, depth, interlace, palette))
    pil = Image.open(path)
    assert pil.mode == ("P" if kind == "palette" else "1" if depth == 1 else "L")
    got, want = read_png(path), np.asarray(pil)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img if kind == "palette" or depth == 1
                                  else img * (255 // ((1 << depth) - 1)))
    t_img, j_img = load_both(path)
    assert t_img.dtype == j_img.dtype == np.float32
    np.testing.assert_array_equal(t_img, j_img)


def test_jpeg_capture_loads_as_in_jax(tmp_path):
    """The tabletop's frames as JPEGs (4:2:0, quality 90) and no w / h in
    transforms.json: the nerfstudio parsers give the same cameras (sizes
    from the JPEG header) and the datasets frames within 1/255."""
    scene = generate_tabletop(tmp_path / "png", width=37, height=29, n_views=2,
                              feature_downscale=1, seed_points=200)
    root = tmp_path / "jpeg"
    root.mkdir()
    for sub in scene.iterdir():
        if sub.name not in ("images", "transforms.json"):
            (root / sub.name).symlink_to(sub)
    (root / "images").mkdir()
    meta = json.loads((scene / "transforms.json").read_text())
    meta.pop("w"), meta.pop("h")
    for f in meta["frames"]:
        src = scene / f["file_path"]
        f["file_path"] = f["file_path"].replace(".png", ".jpg")
        Image.open(src).convert("RGB").save(root / f["file_path"], "JPEG", quality=90)
    (root / "transforms.json").write_text(json.dumps(meta))
    got, want = t_resolve(root, "nerfstudio").parse(), j_resolve(root, "nerfstudio").parse()
    _assert_outputs_equal(got, want)
    assert all(str(p).endswith(".jpg") for p in got.image_filenames)
    tds, jds = TDataset(got), JDataset(want)
    for i in range(len(tds)):
        t_data, j_data = tds.get_data(i), jds.get_data(i)
        assert set(t_data) == set(j_data)
        assert float(np.abs(t_data["image"] - j_data["image"]).max()) <= 1.0 / 255.0
        for k in set(j_data) - {"image"}:
            np.testing.assert_array_equal(t_data[k], j_data[k], err_msg=k)


def test_jpeg_at_capture_size_matches_pillow(tmp_path):
    """An 800x800 4:2:0 frame at quality 95, the trainer's capture size:
    within 1 of Pillow (its decode time is this test's, `--durations`)."""
    path = tmp_path / "big.jpg"
    Image.fromarray(smooth_noisy(800, 800, 3, seed=8)).save(path, "JPEG", quality=95)
    got, want = read_jpeg(path), np.asarray(Image.open(path))
    assert got.shape == (800, 800, 3)
    assert int(np.abs(got.astype(np.int64) - want).max()) <= 1
