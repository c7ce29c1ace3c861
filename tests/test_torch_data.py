"""PyTorch port vs the JAX package: the data layer.

The same files (a ray-traced tabletop from the JAX generator, PNGs from
Pillow and from hand-filtered scanlines) go through both packages on the
CPU. Parsers, datamanager draws, the generator's arrays and the PNG reader
are held exactly: they are the same numpy code, so any difference is a
fault. `downscale_batch` (torch bilinear on the device against OpenCV's
INTER_LINEAR) is held at 1e-6 of each channel's max |value| where the size
divides by the factor (both average the same two-by-two blocks in float32,
in another order) and at 1e-5 where it does not (the two compute the
fractional weights with other float32 roundings).
"""

import struct
import subprocess
import sys
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiangrasper_torch import native as t_native
from gaussiangrasper_torch.core.cameras import Camera as TCamera
from gaussiangrasper_torch.data import colmap_io as tcio
from gaussiangrasper_torch.data.dataparsers.zoo import resolve_parser as t_resolve
from gaussiangrasper_torch.data.manager import FullImageDatamanager as TDM
from gaussiangrasper_torch.data.manager import SamplerConfig as TSampler
from gaussiangrasper_torch.data.prefetch import PrefetchingDatamanager
from gaussiangrasper_torch.data.synthetic import generate_tabletop as t_generate
from gaussiangrasper_torch.engine.trainer import downscale_batch as t_downscale
from gaussiangrasper_torch.utils.image_io import png_size, read_png, write_png
from gaussiangrasper_tpu import native as j_native
from gaussiangrasper_tpu.core.cameras import Camera as JCamera
from gaussiangrasper_tpu.data import colmap_io as jcio
from gaussiangrasper_tpu.data.dataparsers.zoo import resolve_parser as j_resolve
from gaussiangrasper_tpu.data.manager import FullImageDatamanager as JDM
from gaussiangrasper_tpu.data.manager import SamplerConfig as JSampler
from gaussiangrasper_tpu.data.synthetic import generate_tabletop as j_generate
from gaussiangrasper_tpu.engine.trainer import downscale_batch as j_downscale

W, H, VIEWS = 64, 48, 4
SMALL_SAMPLER = dict(max_groups=4, pairs_per_group=16, num_points=40, clip_dim=512)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 64x48, 4-view tabletop from the JAX generator."""
    return j_generate(tmp_path_factory.mktemp("tabletop") / "scene", width=W, height=H,
                      n_views=VIEWS, feature_downscale=2, seed_points=400)


# --- PNG ------------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(img: np.ndarray, filters) -> bytes:
    """An 8-bit PNG whose row y is written with filter filters[y % len]."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = img.reshape(h, w * ch).astype(np.int64)
    raw = bytearray()
    prior = np.zeros(w * ch, np.int64)
    for y in range(h):
        x = rows[y]
        a = np.concatenate([np.zeros(ch, np.int64), x[:-ch]])
        c = np.concatenate([np.zeros(ch, np.int64), prior[:-ch]])
        kind = filters[y % len(filters)]
        pred = [0, a, prior, (a + prior) // 2, _paeth(a, prior, c)][kind]
        raw += bytes([kind]) + ((x - pred) % 256).astype(np.uint8).tobytes()
        prior = x

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_undoes_every_filter(channels, tmp_path):
    rng = np.random.default_rng(channels)
    shape = (23, 17) if channels == 1 else (23, 17, channels)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    img[5:12] = img[4:5]  # flat rows: Up / Paeth predict exactly
    path = tmp_path / "f.png"
    path.write_bytes(encode_png(img, [0, 1, 2, 3, 4, 4, 3, 2, 1]))
    np.testing.assert_array_equal(read_png(path), img)
    assert png_size(path) == (17, 23)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_reader_matches_pillow(mode, tmp_path):
    from PIL import Image

    rng = np.random.default_rng(len(mode))
    ch = len(mode)
    y, x = np.mgrid[0:37, 0:53]
    img = np.stack([(x * 3 + y * (k + 1) + rng.integers(0, 9, x.shape)) % 256 for k in range(ch)], -1)
    img = img.astype(np.uint8)
    img = img[..., 0] if ch == 1 else img
    Image.fromarray(img, mode).save(tmp_path / "pil.png")
    want = np.asarray(Image.open(tmp_path / "pil.png"))
    np.testing.assert_array_equal(read_png(tmp_path / "pil.png"), want)
    assert png_size(tmp_path / "pil.png") == Image.open(tmp_path / "pil.png").size
    if ch in (1, 3):  # the port's writer (grey, RGB): Pillow reads back what it wrote
        write_png(tmp_path / "own.png", img)
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "own.png")), img)
        np.testing.assert_array_equal(read_png(tmp_path / "own.png"), img)


def test_png_reader_rejects_other_formats(tmp_path):
    from PIL import Image

    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(tmp_path / "d16.png")
    np.testing.assert_array_equal(read_png(tmp_path / "d16.png"),  # 16-bit is read now
                                  np.asarray(Image.open(tmp_path / "d16.png")))
    Image.fromarray(np.eye(8, dtype=bool)).save(tmp_path / "d1.png")  # 1-bit grey: read now
    np.testing.assert_array_equal(read_png(tmp_path / "d1.png"),
                                  np.asarray(Image.open(tmp_path / "d1.png")))
    Image.fromarray(np.zeros((8, 8), np.uint8)).convert("P").save(tmp_path / "pal.png")
    np.testing.assert_array_equal(read_png(tmp_path / "pal.png"),  # palette: its indices
                                  np.asarray(Image.open(tmp_path / "pal.png")))
    data = bytearray((tmp_path / "d1.png").read_bytes())
    data[24] = 3  # IHDR bit depth 3: no PNG has it
    (tmp_path / "d3.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="bit depth 3, colour type 0"):
        read_png(tmp_path / "d3.png")
    (tmp_path / "x.png").write_bytes(b"not a png at all, not at all")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(tmp_path / "x.png")


# --- the generator ----------------------------------------------------------------


def test_generator_writes_the_jax_generators_files(scene, tmp_path):
    ours = t_generate(tmp_path / "scene", width=W, height=H, n_views=VIEWS, feature_downscale=2,
                      seed_points=400)
    for sub in ("depths", "normals", "masks", "boundary_mask", "features"):
        names = sorted(p.name for p in (scene / sub).iterdir())
        assert names == sorted(p.name for p in (ours / sub).iterdir()) and len(names) == VIEWS
        for name in names:
            a, b = np.load(scene / sub / name), np.load(ours / sub / name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a, err_msg=f"{sub}/{name}")
    for p in sorted((scene / "images").iterdir()):
        np.testing.assert_array_equal(read_png(ours / "images" / p.name), read_png(p))
    for name in ("transforms.json", "sparse/0/points3D.txt"):
        assert (ours / name).read_text() == (scene / name).read_text()


# --- parsers -----------------------------------------------------------------------


def _colmap_scene(scene: Path, root: Path, model="PINHOLE", params=None) -> Path:
    """The tabletop's images and points as a COLMAP text model with random
    world-to-camera poses (the JAX package's writers)."""
    rng = np.random.default_rng(21)
    root.mkdir()
    (root / "images").symlink_to(scene / "images")
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    params = np.array([50.0, 52.0, 31.5, 24.0]) if params is None else params
    jcio.write_cameras_text(sparse / "cameras.txt", {1: jcio.ColmapCamera(model, W, H, params)})
    images = {}
    for i, p in enumerate(sorted((scene / "images").iterdir())):
        q = rng.normal(size=4)
        images[i + 1] = jcio.ColmapImage(q / np.linalg.norm(q), rng.normal(size=3), 1, p.name)
    jcio.write_images_text(sparse / "images.txt", images)
    xyz, rgb, _ = jcio.read_points3d_text(scene / "sparse" / "0" / "points3D.txt")
    jcio.write_points3d_text(sparse / "points3D.txt", xyz, rgb)
    return root


def _assert_outputs_equal(got, want):
    assert [Path(p).name for p in got.image_filenames] == [Path(p).name for p in want.image_filenames]
    for a, b in zip(got.cameras, want.cameras):
        assert (a.fx, a.fy, a.cx, a.cy, a.width, a.height, a.camera_type) == \
            (b.fx, b.fy, b.cx, b.cy, b.width, b.height, b.camera_type)
        np.testing.assert_array_equal(a.camera_to_world, b.camera_to_world)
        np.testing.assert_array_equal(a.distortion, b.distortion)
    assert got.dataparser_scale == want.dataparser_scale
    np.testing.assert_array_equal(got.dataparser_transform, want.dataparser_transform)
    assert set(got.metadata) == set(want.metadata)
    for k in want.metadata:
        np.testing.assert_array_equal(got.metadata[k], want.metadata[k])
    assert got.seed_points is not None and len(got.seed_points[0]) == len(want.seed_points[0]) > 0


@pytest.mark.parametrize("name", ["auto", "nerfstudio", "dnerf"])
def test_transforms_json_parser_matches_jax(scene, name, tmp_path):
    got, want = t_resolve(scene, name).parse(), j_resolve(scene, name).parse()
    assert type(t_resolve(scene, name)).__name__ == "TransformsJsonParser"
    _assert_outputs_equal(got, want)
    # without w / h in transforms.json the size comes from the PNG header
    meta = (scene / "transforms.json").read_text().replace('"w": 64, "h": 48, ', "")
    probe = tmp_path / "probe"
    probe.mkdir()
    for sub in ("images", "sparse"):
        (probe / sub).symlink_to(scene / sub)
    (probe / "transforms.json").write_text(meta)
    assert '"w"' not in meta
    _assert_outputs_equal(t_resolve(probe).parse(), j_resolve(probe).parse())


@pytest.mark.parametrize("name", ["auto", "colmap", "phototourism"])
def test_colmap_parser_matches_jax(scene, name, tmp_path):
    root = _colmap_scene(scene, tmp_path / "colmap")
    assert type(t_resolve(root, name)).__name__ == "ColmapDataParser"
    _assert_outputs_equal(t_resolve(root, name).parse(), j_resolve(root, name).parse())
    # the port's reader gives the JAX reader's arrays
    for a, b in zip(tcio.read_points3d_text(root / "sparse/0/points3D.txt"),
                    jcio.read_points3d_text(root / "sparse/0/points3D.txt")):
        np.testing.assert_array_equal(a, b)


def test_unported_parsers_raise(tmp_path):
    """Every named parser is ported now: the one that raises is the JAX
    package's own stub, phototourism-raw, with its SystemExit; the other
    names and markers resolve to their parsers, as in the JAX package."""
    with pytest.raises(SystemExit, match="image downloads"):
        t_resolve(tmp_path, "phototourism-raw").parse()
    for name in ("scannet", "auto"):
        assert type(t_resolve(tmp_path, name)).__name__ == type(j_resolve(tmp_path, name)).__name__
    (tmp_path / "meta_data.json").write_text("{}")
    assert type(t_resolve(tmp_path)).__name__ == "SdfstudioParser"
    assert type(j_resolve(tmp_path)).__name__ == "SdfstudioParser"
    with pytest.raises(KeyError):
        t_resolve(tmp_path, "no-such-parser")


# --- the datamanager ---------------------------------------------------------------


def _batches(dm, n):
    out = []
    for _ in range(n):
        idx, cam, batch = dm.next_train()
        out.append((idx, cam, {k: np.asarray(v) for k, v in batch.items()}))
    return out


@pytest.mark.parametrize("branch", ["native", "numpy"])
def test_datamanager_draws_match_jax(scene, branch, monkeypatch):
    if branch == "numpy":
        monkeypatch.setattr(j_native, "sample_mask_batch", lambda *a, **k: None)
        monkeypatch.setattr(t_native, "sample_mask_batch", lambda *a, **k: None)
    else:
        assert t_native.branch() == "native" and j_native.load() is not None
    outputs = t_resolve(scene).parse()
    jdm = JDM(j_resolve(scene).parse(), JSampler(**SMALL_SAMPLER), seed=3)
    tdm = TDM(outputs, TSampler(**SMALL_SAMPLER), seed=3, device="cpu")
    want, got = _batches(jdm, 2 * VIEWS + 1), _batches(tdm, 2 * VIEWS + 1)
    assert tdm.sampler_branch == branch
    assert sorted(i for i, _, _ in got[:VIEWS]) == list(range(VIEWS))
    for (ji, jc, jb), (ti, tc, tb) in zip(want, got):
        assert ji == ti and set(jb) == set(tb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        np.testing.assert_array_equal(tc.camera_to_world.numpy(), np.asarray(jc.camera_to_world))
        assert (tc.width, tc.height, float(tc.fx)) == (jc.width, jc.height, float(jc.fx))
    assert any(b["group_valid"].any() and b["point_valid"].any() for _, _, b in got)
    # the prefetcher draws what the plain datamanager draws
    pre = PrefetchingDatamanager(TDM(outputs, TSampler(**SMALL_SAMPLER), seed=3, device="cpu"))
    try:
        for (ti, _, tb), (pi, _, pb) in zip(got, _batches(pre, len(got))):
            assert ti == pi and all(np.array_equal(tb[k], pb[k]) for k in tb)
    finally:
        pre.close()


def test_datamanager_raises_on_distortion(scene, tmp_path):
    """A view with lens distortion no longer raises: the datamanager
    undistorts it once, as the JAX package's does (tests/test_torch_undistort.py
    holds the stages against OpenCV)."""
    root = _colmap_scene(scene, tmp_path / "colmap",
                         model="OPENCV", params=np.array([50.0, 52.0, 31.5, 24.0, 0.1, 0, 0, 0]))
    tdm = TDM(t_resolve(root).parse(), device="cpu")
    jdm = JDM(j_resolve(root).parse())
    for i in range(VIEWS):
        np.testing.assert_array_equal(tdm.view_data(i)["image"], jdm._load(i)["image"])
        assert tdm.cameras[i].fx == jdm.cameras[i].fx != 50.0
        assert not tdm.cameras[i].distortion.any()


def test_native_library_builds_outside_the_package():
    assert t_native.load() is not None
    assert t_native.LIB_PATH.exists() and t_native.LIB_PATH.parent.name == "build"
    assert not list(Path(t_native.__file__).parent.glob("*.so"))


# --- coarse-to-fine downscale -----------------------------------------------------------


@pytest.mark.parametrize("d,size", [(2, (48, 64)), (2, (45, 63)), (4, (48, 64))])
def test_downscale_batch_matches_jax_cv2(d, size):
    h, w = size
    rng = np.random.default_rng(d + h)
    batch = {
        "image": rng.random((h, w, 3), np.float32),
        "depth": rng.uniform(0, 5, (h, w)).astype(np.float32),
        "normal": rng.normal(size=(h, w, 3)).astype(np.float32),
        "valid_mask": rng.random((h, w)) > 0.3,
        "pair_a": np.stack([rng.integers(0, h, (4, 8)), rng.integers(0, w, (4, 8))], -1).astype(np.int32),
        "pair_b": np.stack([rng.integers(0, h, (4, 8)), rng.integers(0, w, (4, 8))], -1).astype(np.int32),
        "points": np.stack([rng.integers(0, h, 20), rng.integers(0, w, 20)], -1).astype(np.int32),
        "gt_clip": rng.normal(size=(20, 512)).astype(np.float32),
    }
    batch["pair_a"][0, 0] = (h - 1, w - 1)  # the clamp at the far corner
    intr = (50.0, 52.0, w / 2, h / 2, np.eye(4, dtype=np.float32)[:3], w, h)
    jcam, jb = j_downscale({k: jnp.asarray(v) for k, v in batch.items()}, JCamera.create(*intr), d)
    tcam, tb = t_downscale({k: torch.as_tensor(v) for k, v in batch.items()}, TCamera.create(*intr), d)
    assert (tcam.width, tcam.height) == (jcam.width, jcam.height) == (w // d, h // d)
    assert float(tcam.fx) == pytest.approx(float(jcam.fx), rel=1e-7)
    rel = 1e-6 if h % d == 0 and w % d == 0 else 1e-5
    for k in ("image", "depth", "normal"):
        assert tb[k].shape == jb[k].shape, k
        want = np.asarray(jb[k])
        np.testing.assert_allclose(tb[k].numpy(), want, atol=rel * np.abs(want).max(), rtol=0,
                                   err_msg=k)
    for k in ("valid_mask", "pair_a", "pair_b", "points", "gt_clip"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
    cam1, b1 = t_downscale(tb, tcam, 1)
    assert cam1 is tcam and b1 is tb


GUARDED_RUN = """
import json
from pathlib import Path
import numpy as np
from gaussiangrasper_torch.data.dataparsers.base import ParsedCamera
from gaussiangrasper_torch.data.dataparsers.zoo import PARSERS, resolve_parser
from gaussiangrasper_torch.data.manager import undistort_image
from gaussiangrasper_torch.data.synthetic import generate_tabletop
from gaussiangrasper_torch.engine.trainer import TrainerConfig, make_trainer
from gaussiangrasper_torch.models.model import GaussianSplatConfig
from gaussiangrasper_torch.ops.rasterize import RasterizeConfig
from tests.test_torch_dataparsers import LAYOUTS, build

tmp = Path(sys.argv[1])
for name in LAYOUTS:  # every parser the port gained, on its fixture layout
    root = build(name, tmp / name)
    for kw in LAYOUTS[name][2]:
        assert PARSERS[name](root, **kw).parse().cameras, name
try:
    PARSERS["phototourism-raw"](tmp).parse()
except SystemExit:
    pass
img = np.random.default_rng(0).integers(0, 256, (24, 32, 3), dtype=np.uint8)
for kind, d in (("perspective", [-0.1, 0.02, 1e-3, 0, 0, 0]), ("fisheye", [0.05, 0, 0, 0, 0.01, 0])):
    cam = ParsedCamera(28.0, 29.0, 16.0, 12.0, 32, 24, np.eye(4)[:3], np.array(d), kind)
    out, cam2 = undistort_image(img, cam)
    assert out.shape == img.shape and cam2.fx != cam.fx, kind
# two pose-optimization train steps on a capture with lens distortion
scene = generate_tabletop(tmp / "scene", width=32, height=24, n_views=2, feature_downscale=2,
                          seed_points=200)
meta = json.loads((scene / "transforms.json").read_text())
(scene / "transforms.json").write_text(json.dumps({**meta, "k1": -0.05, "p1": 1e-3}))
model = GaussianSplatConfig(feature_dim=8, sh_degree=1, pose_opt_mode="SO3xR3",
                            raster=RasterizeConfig(tile_size=16, max_gaussians_per_tile=256))
trainer = make_trainer(TrainerConfig(data=scene, output_dir=tmp / "out", max_iterations=2,
                                     steps_per_save=2, capacity=512, model=model), device="cpu")
assert type(resolve_parser(scene)).__name__ == "TransformsJsonParser"
state = trainer.train()
assert state.step == 2 and state.pose.shape == (2, 6) and trainer.dm.cameras[0].fx != meta["fl_x"]
assert float(state.opt["camera_opt"].accum.abs().max()) > 0
# the sharded and multi-scene modules: the in-process 2-way split of the
# tile-sharded compositor, one sharded step in a gloo world of one rank,
# two multi-scene steps
import dataclasses, torch
from gaussiangrasper_torch.engine.multi_scene import multi_scene_train_step
from gaussiangrasper_torch.models.model import render_inputs
from gaussiangrasper_torch.ops.rasterize import rasterize_projected
from gaussiangrasper_torch.parallel import comm
from gaussiangrasper_torch.parallel.tile_shard import composite_tile_split
from gaussiangrasper_torch.parallel.train import make_sharded_train_step, shard_train_state
plain = dataclasses.replace(model, pose_opt_mode="off")
st0 = make_trainer(TrainerConfig(data=scene, output_dir=tmp / "out0", capacity=512, model=plain),
                   device="cpu").setup()
cam, batch = trainer.dm.get_batch(0)
proj, colors, opac, bg = render_inputs(st0.field, st0.alive, cam, 0, plain)
split = composite_tile_split(proj, colors, opac, bg, cam.width, cam.height, plain.raster, d=2)
whole = rasterize_projected(proj, colors, opac, bg, cam.width, cam.height, plain.raster)
assert torch.equal(split["image"], whole["image"])
(tmp / "store").mkdir()
mesh = comm.init_world(1, 1, "cpu", store_dir=str(tmp / "store"))
step = make_sharded_train_step(mesh, plain, 512, tile_shard=True, alive=st0.alive)
local, metrics = step(shard_train_state(st0, mesh), cam, batch)
comm.close_world()
assert local.step == 1 and int(metrics["gathered_rows"]) > 0
states, _ = multi_scene_train_step([st0, st0], [cam, cam], [batch, batch], plain)
states, _ = multi_scene_train_step(states, [cam, cam], [batch, batch], plain)
assert states[1].step == 2
# the capture and viewing tools: camera paths, the JPEG writer and resize, a
# viewer frame, a trace window, generate_data, process_data and equirect crops
from gaussiangrasper_torch.core.camera_paths import interpolate_path, spiral_path
from gaussiangrasper_torch.data.equirect import equirect_to_perspective
from gaussiangrasper_torch.scripts import generate_data, process_data, viewer
from gaussiangrasper_torch.utils.image_io import encode_jpeg, read_jpeg, resize_bilinear, write_png
from gaussiangrasper_torch.utils.profiler import TraceCapture
assert len(interpolate_path(trainer.dm.cameras, 3)) == 4 and len(spiral_path(trainer.dm.cameras[0], 5)) == 5
assert resize_bilinear(img, 16, 12).shape == (12, 16, 3) and read_jpeg(encode_jpeg(img)).shape == img.shape
srv = viewer.make_server(lambda: st0, plain, 0, 32, 24)
assert read_jpeg(srv.render_pose([0, 0, 2], [0, 0, 0], [0, 1, 0])).shape == (24, 32, 3)
srv.server_close()
tc = TraceCapture(tmp / "trace", 0, 1)
tc.maybe_step(0); tc.maybe_step(1)
assert tc.path.exists()
cap = tmp / "capture"
for d in ("color", "depth", "poses"):
    (cap / d).mkdir(parents=True)
(cap / "intrinsics.json").write_text(json.dumps({"fx": 30.0, "fy": 30.0, "cx": 16.0, "cy": 12.0,
                                                  "width": 32, "height": 24}))
for i in range(2):
    write_png(cap / "color" / f"{i}.png", img)
    np.save(cap / "depth" / f"{i}.npy", np.full((24, 32), 1.5, np.float32))
    np.save(cap / "poses" / f"{i}.npy", np.eye(4))
assert generate_data.main(["--capture", str(cap), "--output", str(tmp / "gen"), "--icp",
                           "--device", "cpu"])["frames"] == 2
process_data.main(["images", "--data", str(tmp / "gen" / "images"), "--output", str(tmp / "proc")])
assert (tmp / "proc" / "images_8" / "frame_00000.png").exists()
assert equirect_to_perspective(img, 90.0, 180.0, 10.0, (8, 8)).shape == (8, 8, 3)
"""


def test_port_imports_no_jax_pillow_opencv(tmp_path):
    """The data layer and trainer import, and run, in a process where jax,
    gaussiangrasper_tpu, PIL, cv2 and sklearn cannot be imported: every
    dataparser on its fixture layout, undistort_image in both branches,
    two pose-optimization train steps on a distorted capture, the
    in-process 2-way split of the tile-sharded compositor, one sharded
    train step in a gloo world of one rank, two multi-scene steps, and the
    capture and viewing tools (camera paths, the JPEG writer and resize, a
    viewer frame, a trace window, generate_data with ICP, process_data and
    an equirect crop; an import made inside a function would otherwise slip
    past)."""
    code = (
        "import sys\n"
        # torch.profiler loads torch._inductor, whose trace rules look for
        # optional packages (sklearn among them) with find_spec, which the
        # block below answers with ImportError; load it first, and show it
        # brought in none of the blocked packages
        "import torch._inductor\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in\n"
        "            ('jax', 'gaussiangrasper_tpu', 'PIL', 'cv2', 'sklearn')]\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'gaussiangrasper_tpu', 'PIL', 'cv2', 'sklearn'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import gaussiangrasper_torch.scripts.train, gaussiangrasper_torch.scripts.render\n"
        "import gaussiangrasper_torch.data.synthetic, gaussiangrasper_torch.data.prefetch\n"
        "import gaussiangrasper_torch.scripts.common, gaussiangrasper_torch.utils.writer\n"
        "import gaussiangrasper_torch.parallel.host_loop, gaussiangrasper_torch.engine.multi_scene\n"
        "import gaussiangrasper_torch.scripts.update, gaussiangrasper_torch.scripts.viewer\n"
        "import gaussiangrasper_torch.scripts.generate_data, gaussiangrasper_torch.scripts.process_data\n"
        "import gaussiangrasper_torch.data.equirect, gaussiangrasper_torch.utils.profiler\n"
        + GUARDED_RUN
    )
    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
