"""PyTorch port vs the JAX package: the capture and viewing tools.

- Camera paths (`core/camera_paths.py`) bit-equal to the JAX functions, and
  `render --traj` on a port run: as many frames as the JAX CLI's paths over
  the same capture, each frame the port's own render of the path camera.
- `Profiler.summary()` the JAX text; `TraceCapture` on an 18-step trainer
  run writes a Chrome trace whose step ranges are 12..16.
- `generate_data.main` on tests/test_cli.py's capture through both packages
  (also with --icp): normals, depths and the cloud within 1e-5, the text
  files equal, the images' pixels equal, `icp_refine` within 1e-6.
- Every `process_data` subcommand of tests/test_process_data.py through both
  packages on seeded frames: the same output tree, JSON within 1e-6, JPEGs
  byte for byte (Pillow's `save` / cv2.imwrite and the port's `write_jpeg`),
  PNGs pixel for pixel (bytes where the JAX CLI copies), the same gating
  without ffmpeg / colmap / hloc.
- `equirect_to_perspective` bit-equal to cv2.remap (INTER_CUBIC, BORDER_WRAP)
  for uint8 RGB at the JAX tests' yaw / pitch cases, the +-180 seam
  included; `sampling_pattern` / `crop_resolution` equal.
"""

import json
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from gaussiangrasper_torch.core import camera_paths as tpaths
from gaussiangrasper_torch.core.cameras import Camera as TCamera
from gaussiangrasper_torch.data import equirect as tequirect
from gaussiangrasper_torch.data.dataparsers.base import ParsedCamera as TParsed
from gaussiangrasper_torch.data.dataparsers.zoo import resolve_parser as t_resolve
from gaussiangrasper_torch.engine.trainer import TrainerConfig, make_trainer
from gaussiangrasper_torch.models.model import GaussianSplatConfig as TConfig
from gaussiangrasper_torch.ops.rasterize import RasterizeConfig as TRC
from gaussiangrasper_torch.scripts import generate_data as tgen
from gaussiangrasper_torch.scripts import process_data as tproc
from gaussiangrasper_torch.scripts import render as trender
from gaussiangrasper_torch.utils import profiler as tprof
from gaussiangrasper_torch.utils.image_io import read_png
from gaussiangrasper_tpu.core import camera_paths as jpaths
from gaussiangrasper_tpu.data import equirect as jequirect
from gaussiangrasper_tpu.data.dataparsers.base import ParsedCamera as JParsed
from gaussiangrasper_tpu.data.dataparsers.zoo import resolve_parser as j_resolve
from gaussiangrasper_tpu.scripts import generate_data as jgen
from gaussiangrasper_tpu.scripts import process_data as jproc
from gaussiangrasper_tpu.utils import profiler as jprof
from tests.test_cli import capture_dir  # noqa: F401  (the capture fixture)
from tests import test_process_data as tpd

SMALL = TConfig(feature_dim=8, sh_degree=1, num_downscales=0, warmup_length=2, refine_every=100,
                raster=TRC(tile_size=16, max_gaussians_per_tile=256))


def _cameras(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        c2w = np.concatenate([jpaths._quat_to_rot(q), rng.normal(size=(3, 1))], 1)
        kw = dict(fx=float(rng.uniform(20, 40)), fy=float(rng.uniform(20, 40)), cx=16.0, cy=12.0,
                  width=32, height=24, camera_to_world=c2w.astype(np.float32))
        out.append((JParsed(**kw), TParsed(**kw)))
    return out


def _same_camera(j, t):
    assert (j.fx, j.fy, j.cx, j.cy, j.width, j.height) == (t.fx, t.fy, t.cx, t.cy, t.width, t.height)
    assert j.camera_to_world.dtype == t.camera_to_world.dtype
    np.testing.assert_array_equal(j.camera_to_world, t.camera_to_world)


@pytest.mark.parametrize("steps", [1, 6, 10])
def test_interpolate_path_is_bit_equal(steps):
    cams = _cameras(4)
    # a pair of nearly equal rotations takes the lerp branch
    near = np.array(cams[2][0].camera_to_world)
    near[:3, 3] += 0.1
    cams.append((JParsed(30.0, 30.0, 16.0, 12.0, 32, 24, near),
                 TParsed(30.0, 30.0, 16.0, 12.0, 32, 24, near)))
    jp = jpaths.interpolate_path([c[0] for c in cams], steps_per_transition=steps)
    tp = tpaths.interpolate_path([c[1] for c in cams], steps_per_transition=steps)
    assert len(jp) == len(tp) == steps * 4 + 1
    for j, t in zip(jp, tp):
        _same_camera(j, t)


@pytest.mark.parametrize("n_frames,radius,rotations", [(16, 0.1, 2.0), (7, 0.3, 1.5)])
def test_spiral_path_is_bit_equal(n_frames, radius, rotations):
    j, t = _cameras(1, seed=3)[0]
    jp = jpaths.spiral_path(j, n_frames, radius, rotations)
    tp = tpaths.spiral_path(t, n_frames, radius, rotations)
    assert len(jp) == len(tp) == n_frames
    for a, b in zip(jp, tp):
        _same_camera(a, b)


def test_profiler_summary_matches_jax():
    rng = np.random.default_rng(0)
    jp, tp = jprof.Profiler(), tprof.Profiler()
    for name in ("render", "a much longer section name", "train_step"):
        for _ in range(int(rng.integers(1, 5))):
            dt = float(rng.uniform(0, 2))
            for p in (jp, tp):
                p.totals[name] += dt
                p.counts[name] += 1
    assert tp.summary() == jp.summary()
    with tp.section("timed"):
        pass
    wrapped = tp.time_function(lambda x: x + 1, name="fn")
    assert wrapped(1) == 2 and tp.counts["timed"] == tp.counts["fn"] == 1


@pytest.fixture(scope="module")
def datasets(capture_dir, tmp_path_factory):  # noqa: F811
    """tests/test_cli.py's capture through both packages' generate_data, on
    the CPU, plain and with --icp."""
    out = {}
    for icp in ((), ("--icp",)):
        args = ["--capture", str(capture_dir), "--subsample", "4", "--depth-max", "5.0", *icp]
        jdir, tdir = tmp_path_factory.mktemp("jgen"), tmp_path_factory.mktemp("tgen")
        jgen.main([*args, "--output", str(jdir)])
        res = tgen.main([*args, "--output", str(tdir), "--device", "cpu"])
        out[bool(icp)] = (jdir, tdir, res)
    return out


@pytest.mark.parametrize("icp", [False, True])
def test_generate_data_matches_jax(datasets, capture_dir, icp):  # noqa: F811
    jdir, tdir, res = datasets[icp]
    files = sorted(p.relative_to(jdir) for p in jdir.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(tdir) for p in tdir.rglob("*") if p.is_file())
    assert res["frames"] == 3 and res["points"] == 3 * 32 * 24 // 4
    for rel in files:
        a, b = jdir / rel, tdir / rel
        if rel.suffix == ".npy":
            x, y = np.load(a), np.load(b)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_allclose(y, x, atol=1e-5, rtol=0)
        elif rel.suffix == ".png":
            np.testing.assert_array_equal(np.asarray(Image.open(b)), np.asarray(Image.open(a)))
        else:  # transforms.json, sparse/0/*.txt
            assert b.read_text() == a.read_text(), rel
    normals = np.load(tdir / "normals" / "frame_00000.npy")
    assert normals.shape == (24, 32, 3) and (normals[1:-1, 1:-1, 2] < -0.99).all()  # facing the camera
    parsed = t_resolve(tdir).parse()
    assert len(parsed.cameras) == 3 and len(parsed.seed_points[0]) == res["points"]
    if icp:
        assert len(res["icp"]) == 2


def test_icp_refine_matches_jax():
    rng = np.random.default_rng(0)
    dst = rng.uniform(-0.5, 0.5, (400, 3)) * [1.0, 1.0, 0.3]
    ang = 0.03
    r = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    src = dst @ r.T + [0.01, -0.02, 0.005]
    np.testing.assert_allclose(tgen.icp_refine(src, dst), jgen.icp_refine(src, dst), atol=1e-6, rtol=0)


def test_generate_data_reads_16_bit_png_depth(tmp_path):
    depth = np.random.default_rng(0).integers(0, 4000, (7, 9), dtype=np.uint16)
    Image.fromarray(depth).save(tmp_path / "d.png")
    np.testing.assert_array_equal(tgen.load_depth(tmp_path / "d.png"),
                                  jgen.load_depth(tmp_path / "d.png"))


@pytest.fixture(scope="module")
def port_run(datasets, tmp_path_factory):
    """A one-step port trainer run on the port's generated capture."""
    _, tdir, _ = datasets[False]
    config = TrainerConfig(data=tdir, output_dir=tmp_path_factory.mktemp("run"), max_iterations=1,
                           steps_per_save=1, capacity=1024, model=SMALL)
    trainer = make_trainer(config, device="cpu")
    trainer.train()
    return config.run_dir, trainer


@pytest.mark.parametrize("traj,want", [("interpolate", 6 * 2 + 1), ("spiral", 4)])
def test_render_traj(datasets, port_run, traj, want):
    jdir, _, _ = datasets[False]
    run, trainer = port_run
    trender.main(["--run-dir", str(run), "--traj", traj, "--num-views", "4", "--device", "cpu"])
    frames = sorted((run / "renders" / "traj").glob("*.png"))
    jcams = j_resolve(jdir).parse().cameras  # the JAX CLI's path over the same capture
    jpath = (jpaths.interpolate_path(jcams, steps_per_transition=6) if traj == "interpolate"
             else jpaths.spiral_path(jcams[0], n_frames=4))
    assert len(frames) == len(jpath) == want
    state = trainer.state
    for f, pc in zip(frames, jpath):
        cam = TCamera.create(pc.fx, pc.fy, pc.cx, pc.cy, pc.camera_to_world, pc.width, pc.height)
        with torch.no_grad():
            rgb = trender.render_view(state, cam, SMALL)["rgb"].numpy()
        np.testing.assert_array_equal(read_png(f), trender._to_u8(rgb))
    for f in frames:
        f.unlink()


def test_trace_capture_covers_steps_12_to_16(datasets, tmp_path):
    _, tdir, _ = datasets[False]
    config = TrainerConfig(data=tdir, output_dir=tmp_path, max_iterations=18, steps_per_save=18,
                           capacity=1024, profiler="trace", model=SMALL)
    trainer = make_trainer(config, device="cpu")
    trainer.train()
    traces = list((config.run_dir / "profiler_traces").iterdir())
    assert [t.name for t in traces] == ["trace_12_17.json"]
    events = json.loads(traces[0].read_text())["traceEvents"]
    steps = sorted({e["name"] for e in events if e.get("name", "").startswith("train_step#")})
    assert steps == [f"train_step#{i}" for i in range(12, 17)]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_trace_capture_close_writes_an_open_window(tmp_path):
    tc = tprof.TraceCapture(tmp_path / "t", start_step=0, num_steps=5)
    tc.maybe_step(0)
    torch.ones(3).sum()
    tc.close()
    assert tc.path.name == "trace_0_5.json" and tc.path.exists()
    tc.close()  # nothing open: a no-op


# --- process_data ------------------------------------------------------------------------


def _frame(path: Path, w: int, h: int, seed: int, grey: bool = False):
    """A smooth seeded frame with noise (JPEG blocks of every kind)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = 127 + 90 * np.sin(x[..., None] / 5.0 + np.arange(3)) * np.cos(y[..., None] / 4.0)
    img = np.clip(img + rng.normal(0, 15, (h, w, 3)), 0, 255).astype(np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(img[..., 0] if grey else img).save(path)


def _images_capture(root: Path):
    _frame(root / "im0.png", 37, 23, 0)
    _frame(root / "im1.jpg", 40, 30, 1)
    _frame(root / "im2.jpg", 33, 17, 2, grey=True)
    tpd._colmap_model(root, n=3)


def _polycam_capture(root: Path):
    imgs, cams = root / "keyframes" / "corrected_images", root / "keyframes" / "corrected_cameras"
    cams.mkdir(parents=True)
    for i, blur in enumerate((100.0, 5.0, 60.0)):
        _frame(imgs / f"{i}.jpg", 40, 30, 10 + i)
        cam = {"fx": 20.0, "fy": 20.0, "cx": 20.0, "cy": 15.0, "width": 40, "height": 30,
               "blur_score": blur}
        for rname, row in zip("012", np.eye(4)[:3] + 0.01 * i):
            for cname, v in zip("0123", row):
                cam[f"t_{rname}{cname}"] = float(v)
        (cams / f"{i}.json").write_text(json.dumps(cam))


def _record3d_capture(root: Path):
    for i in range(4):
        _frame(root / "rgb" / f"{i}.jpg", 24, 18, 20 + i)
    poses = [[0.0, 0.1 * i, 0.0, 1.0, 0.1 * i, 0.0, 0.2] for i in range(4)]
    k = np.array([[tpd.F, 0, 12.0], [0, tpd.F, 9.0], [0, 0, 1]])
    (root / "metadata.json").write_text(json.dumps({"poses": poses, "K": k.T.reshape(-1).tolist(),
                                                    "w": 24, "h": 18}))


def _metashape_capture(root: Path):
    _frame(root / "imgs" / "shot0.png", 8, 6, 30)
    (root / "cameras.xml").write_text(f"""<?xml version="1.0"?>
<document><chunk>
  <sensors><sensor id="0" type="frame"><resolution width="8" height="6"/>
    <calibration><f>{tpd.F}</f><cx>0.5</cx><cy>-0.5</cy><k1>0.01</k1></calibration></sensor></sensors>
  <components><component id="0"><transform><rotation>1 0 0 0 1 0 0 0 1</rotation>
    <translation>2 0 0</translation><scale>2</scale></transform></component></components>
  <cameras>
    <camera id="0" sensor_id="0" component_id="0" label="shot0">
      <transform>0 -1 0 0.3 1 0 0 0 0 0 1 1 0 0 0 1</transform></camera>
    <camera id="1" sensor_id="0" label="missing_image">
      <transform>1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1</transform></camera>
  </cameras>
</chunk></document>""")


def _realitycapture_capture(root: Path):
    _frame(root / "imgs" / "dji0.png", 8, 6, 40)
    (root / "poses.csv").write_text(
        "#name,x,y,alt,heading,pitch,roll,f,px,py,k1,k2,k3,k4,t1,t2\n"
        "dji0.png,1.0,2.0,3.0,10,5,-3,36,0.1,0.2,0.01,0,0,0,0,0\n"
        "missing.png,0,0,0,0,0,0,36,0,0,0,0,0,0,0,0\n")


def _odm_capture(root: Path):
    _frame(root / "images" / "a.jpg", 8, 6, 50)
    (root / "cameras.json").write_text(json.dumps({
        "cam0": {"projection_type": "brown", "width": 8, "height": 6, "focal": 0.9,
                 "c_x": 0.1, "c_y": -0.1, "k1": 0.02}}))
    (root / "odm_report").mkdir()
    (root / "odm_report" / "shots.geojson").write_text(json.dumps({"features": [
        {"properties": {"filename": "a.jpg", "rotation": [0.1, -0.2, 0.3],
                        "translation": [1.0, 2.0, 3.0]}},
        {"properties": {"filename": "gone.jpg", "rotation": [0.0, 0.0, 0.0],
                        "translation": [0.0, 0.0, 0.0]}}]}))


def _equirect_capture(root: Path):
    root.mkdir(parents=True)
    img = tpd.TestEquirect._lonlat_image(64, 128).astype(np.uint8)
    img[..., 2] = np.random.default_rng(60).integers(0, 256, img.shape[:2])
    cv2.imwrite(str(root / "e0.png"), img)


CASES = {  # case -> (the function writing its capture, argv after the subcommand; {d}: the capture)
    "images": (_images_capture, ["--data", "{d}"]),
    "polycam": (_polycam_capture, ["--data", "{d}", "--crop-border-pixels", "3"]),
    "polycam_nocrop": (_polycam_capture, ["--data", "{d}", "--crop-border-pixels", "0"]),
    "record3d": (_record3d_capture, ["--data", "{d}", "--max-images", "3"]),
    "metashape": (_metashape_capture, ["--data", "{d}/imgs", "--xml", "{d}/cameras.xml"]),
    "realitycapture": (_realitycapture_capture, ["--data", "{d}/imgs", "--csv", "{d}/poses.csv"]),
    "odm": (_odm_capture, ["--data", "{d}"]),
    "equirect": (_equirect_capture, ["--data", "{d}", "--images-per-equirect", "8",
                                     "--resolution", "24"]),
}


def _tree(root: Path) -> list:
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def _same_json(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _same_json(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same_json(x, y)
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= 1e-6, (a, b)
    else:
        assert a == b


@pytest.mark.parametrize("case", sorted(CASES))
def test_process_data_matches_jax(case, tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)  # no colmap / ffmpeg here
    build, argv = CASES[case]
    mode = case.split("_")[0]
    roots = {}
    for pkg, main, extra in (("jax", jproc.main, []), ("torch", tproc.main, ["--device", "cpu"])):
        cap = tmp_path / pkg / "capture"
        build(cap)
        args = [a.format(d=cap) for a in argv] + ["--output", str(tmp_path / pkg / "out")]
        main([mode, *args, *(extra if mode == "equirect" else [])])
        roots[pkg] = tmp_path / pkg
    jroot, troot = roots["jax"], roots["torch"]
    files = _tree(jroot)
    assert files == _tree(troot)
    sources = {p.read_bytes() for p in (jroot / "capture").rglob("*") if p.is_file()}
    n_images = 0
    for rel in files:
        a, b = jroot / rel, troot / rel
        if rel.suffix == ".json":
            _same_json(json.loads(a.read_text()), json.loads(b.read_text()))
        elif rel.suffix.lower() in (".jpg", ".jpeg"):  # copied, or saved by Pillow / cv2
            assert b.read_bytes() == a.read_bytes(), rel
            n_images += 1
        elif rel.suffix == ".png":
            np.testing.assert_array_equal(np.asarray(Image.open(b)), np.asarray(Image.open(a)))
            if a.read_bytes() in sources:  # the JAX CLI copied it
                assert b.read_bytes() == a.read_bytes(), rel
            n_images += 1
        else:
            assert b.read_bytes() == a.read_bytes(), rel
    assert n_images > 0


@pytest.mark.parametrize("argv,match", [
    (["video", "--data", "v.mp4"], "ffmpeg"),
    (["equirect", "--data", "v.mp4"], "ffmpeg"),
    (["hloc", "--data", "x"], "Hierarchical-Localization"),
])
def test_process_data_gates_without_binaries(argv, match, tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    (tmp_path / "v.mp4").write_bytes(b"\x00")
    argv = [a if a != "v.mp4" else str(tmp_path / a) for a in argv]
    msgs = []
    for main in (jproc.main, tproc.main):
        with pytest.raises(SystemExit, match=match) as e:
            main([*argv, "--output", str(tmp_path / "o")])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_images_without_colmap_prints_the_same_hint(tmp_path, monkeypatch, capsys):
    outs = []
    for which in (lambda name: None, lambda name: "/usr/bin/colmap"):
        monkeypatch.setattr(shutil, "which", which)
        for main in (jproc.main, tproc.main):
            cap = tmp_path / f"c{len(outs)}"
            _frame(cap / "im0.png", 12, 10, 0)
            main(["images", "--data", str(cap), "--output", str(tmp_path / "o"),
                  "--skip-downscale"])
            outs.append(capsys.readouterr().out.replace(str(tmp_path / "o"), "OUT"))
    assert outs[0] == outs[1] and outs[2] == outs[3] and outs[0] != outs[2]


# --- equirect ----------------------------------------------------------------------------


@pytest.mark.parametrize("yaw,pitch", [(0, 0), (90, 0), (0, 45), (180, 0), (-180, 0), (-120, -30),
                                       (179.5, 60), (37.5, -89)])
@pytest.mark.parametrize("fov,size", [(90.0, (33, 33)), (60.0, (21, 21)), (120.0, (24, 40))])
def test_equirect_to_perspective_is_cv2_remap(yaw, pitch, fov, size):
    rng = np.random.default_rng(int(abs(yaw * 7 + pitch)))
    img = rng.integers(0, 256, (64, 128, 3), dtype=np.uint8)
    want = jequirect.equirect_to_perspective(img, fov, yaw, pitch, size)
    got = tequirect.equirect_to_perspective(img, fov, yaw, pitch, size).numpy()
    np.testing.assert_array_equal(got, want)
    grey = img[..., 1].copy()
    np.testing.assert_array_equal(
        tequirect.equirect_to_perspective(grey, fov, yaw, pitch, size).numpy(),
        jequirect.equirect_to_perspective(grey, fov, yaw, pitch, size))


def test_remap_matches_cv2_within_one_period():
    """Random float maps reaching one image period past each side (the
    crops' maps stay inside the image), enough of them (3 x 2^18 samples)
    that a weight or a sum rounded otherwise than OpenCV's fused
    multiply-adds shows."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    mx = rng.uniform(-30, 60, (512, 512)).astype(np.float32)
    my = rng.uniform(-20, 40, (512, 512)).astype(np.float32)
    mx[0, :8] = np.arange(8) * 0.5  # half pixels
    want = cv2.remap(img, mx, my, cv2.INTER_CUBIC, borderMode=cv2.BORDER_WRAP)
    got = tequirect.remap_cubic_wrap(torch.as_tensor(img), torch.as_tensor(mx), torch.as_tensor(my))
    np.testing.assert_array_equal(got.numpy(), want)


def test_equirect_maps_patterns_and_resolution_match_jax():
    for args in [((64, 128), 90.0, 30.0, -10.0, (17, 19)), ((180, 360), 120.0, -180.0, 45.0, (8, 8))]:
        for a, b in zip(tequirect.equirect_maps(*args), jequirect.equirect_maps(*args)):
            np.testing.assert_array_equal(a, b)
    for n in (8, 14):
        for crop in [(0.0, 0.0, 0.0, 0.0), (0.0, 0.9, 0.0, 0.0), (0.3, 0.2, 0.1, 0.25), (0.7, 0, 0, 0)]:
            assert tequirect.sampling_pattern(n, crop) == jequirect.sampling_pattern(n, crop)
    for bad in [(8, (0.0, 2.0, 0.0, 0.0)), (9, (0.0, 0.0, 0.0, 0.0))]:
        with pytest.raises(ValueError):
            tequirect.sampling_pattern(*bad)
    for size, n in [((1000, 2000), 8), ((512, 1024), 14), ((17, 33), 8)]:
        assert tequirect.crop_resolution(size, n) == jequirect.crop_resolution(size, n)
