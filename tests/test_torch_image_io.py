"""PyTorch port vs Pillow and the JAX package: frames that are not 8-bit
plain PNGs.

- JPEG: files that Pillow writes (grey; YCbCr at 4:4:4, 4:2:2 and 4:2:0;
  a restart interval; optimized Huffman tables; an SOF1 header; sizes that
  are and are not multiples of the MCU) decode to Pillow's array within 1
  per channel (libjpeg's islow IDCT, fancy upsampling and colour tables);
  progressive JPEG raises.
- PNG: Adam7-interlaced and 16-bit files load to exactly the arrays of the
  JAX dataset's `load_image` (Pillow underneath: 16-bit grey as uint16,
  other 16-bit types as their high bytes).
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


def test_progressive_jpeg_raises(tmp_path):
    path = tmp_path / "p.jpg"
    Image.fromarray(smooth_noisy(24, 32, 3, 0)).save(path, "JPEG", progressive=True)
    for fn in (read_jpeg, read_image, image_size):
        with pytest.raises(ValueError, match="progressive"):
            fn(path)
    (tmp_path / "x.gif").write_bytes(b"GIF89a....")
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        read_image(tmp_path / "x.gif")


def encode_png(img: np.ndarray, depth: int, interlace: bool) -> bytes:
    """A PNG of uint8 (depth 8) or uint16 (depth 16) samples, plain or
    Adam7-interlaced, each scanline with filter type (row + pass) % 5."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    bpp = ch * depth // 8
    raw = img.astype(">u2").view(np.uint8) if depth == 16 else img.astype(np.uint8)
    raw = raw.reshape(h, w, bpp)
    passes = [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
              (0, 1, 1, 2)] if interlace else [(0, 0, 1, 1)]
    out = bytearray()
    for p, (x0, y0, dx, dy) in enumerate(passes):
        sub = raw[y0::dy, x0::dx].reshape(len(range(y0, h, dy)), -1).astype(np.int64)
        if sub.size == 0:
            continue
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
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


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
