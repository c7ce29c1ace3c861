"""PyTorch port vs the JAX package: the named dataparsers and layout
auto-detection.

Each layout of tests/test_dataparsers.py is rebuilt here (with seeded,
non-trivial poses where the layout has poses, and PNGs written by the
port's own writer) and parsed by both packages; the outputs must be equal
(cameras, c2w, intrinsics, splits, dataparser_scale /
dataparser_transform, filenames, metadata). Both parse with the same numpy
operations, so every comparison is exact.

`LAYOUTS` and `build` import nothing of JAX, Pillow or the JAX package:
tests/test_torch_data.py's import guard runs every parser on them in a
process where those cannot be imported. The JAX package is imported
inside the tests for the same reason.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest

from gaussiangrasper_torch.data.dataparsers.zoo import PARSERS, resolve_parser
from gaussiangrasper_torch.utils.image_io import write_png

W, H = 8, 6


def _png(path, w=W, h=H):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_png(path, np.zeros((h, w, 3), np.uint8))


def _rotation(rng):
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _pose(rng, scale=1.0):
    p = np.eye(4)
    p[:3, :3] = _rotation(rng)
    p[:3, 3] = rng.normal(scale=scale, size=3)
    return p


def _blender(root, rng):
    meta = {"camera_angle_x": 0.8, "frames": [
        {"file_path": f"./r_{i}", "transform_matrix": _pose(rng).tolist()} for i in range(3)]}
    for split in ("train", "val"):
        (root / f"transforms_{split}.json").write_text(json.dumps(meta))
    for i in range(3):
        _png(root / f"r_{i}.png")


def _instant_ngp(root, rng):
    meta = {"camera_angle_x": 0.8, "w": W, "h": H, "k1": 0.01, "p2": -0.002, "aabb_scale": 4,
            "frames": [{"file_path": "im0.png", "transform_matrix": _pose(rng, 3).tolist()},
                       {"file_path": "im1", "fl_x": 9.5, "transform_matrix": _pose(rng).tolist()}]}
    (root / "transforms.json").write_text(json.dumps(meta))
    _png(root / "im0.png")
    _png(root / "im1.png")


def _minimal(root, rng):
    _png(root / "img0.png")
    _png(root / "img1.png")
    np.savez(root / "train.npz", image_filenames=np.array(["img0.png", "img1.png"]),
             cameras={"fx": np.array([10.0, 11.0]), "fy": np.array([10.0, 11.5]),
                      "cx": np.array([4.0, 4.1]), "cy": np.array([3.0, 2.9]),
                      "width": np.array([W, W]), "height": np.array([H, H]),
                      "camera_to_worlds": np.stack([_pose(rng), _pose(rng)])},
             scene_box=np.array([[-1, -1, -1], [1, 1, 1]]),
             mask_filenames=np.array(["m0.png", "m1.png"]))


def _scannet(root, rng):
    for i in range(12):  # 11 valid poses: 10 train views, 1 eval view
        _png(root / "color" / f"{i}.jpg")  # a PNG under ScanNet's name: the header decides
        _png(root / "depth" / f"{i}.png")
    (root / "pose").mkdir()
    for i in range(12):
        pose = _pose(rng, 2.0)
        if i == 1:
            pose[1, 3] = np.inf  # a non-finite pose is skipped
        np.savetxt(root / "pose" / f"{i}.txt", pose)
    (root / "intrinsic").mkdir()
    k = np.eye(4)
    k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 7.0, 7.5, 4.0, 3.0
    np.savetxt(root / "intrinsic" / "intrinsic_color.txt", k)


def _sdfstudio(root, rng):
    intr = np.eye(4)
    intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2] = 11.0, 11.5, 4.0, 3.0
    meta = {"height": H, "width": W, "scene_box": {"aabb": [[-1, -1, -1], [1, 1, 1]]},
            "frames": [{"rgb_path": f"{i}.png", "camtoworld": _pose(rng).tolist(),
                        "intrinsics": intr.tolist()} for i in range(2)]}
    (root / "meta_data.json").write_text(json.dumps(meta))
    for i in range(2):
        _png(root / f"{i}.png")


def _arkitscenes(root, rng):
    video = root.name
    base = root / f"{video}_frames"
    (base / "lowres_wide_intrinsics").mkdir(parents=True)
    lines = []
    for i in range(12):
        ts = 1.0 + 0.5 * i
        _png(base / "lowres_wide" / f"{video}_{ts:.3f}.png")
        np.savetxt(base / "lowres_wide_intrinsics" / f"{video}_{ts:.3f}.pincam",
                   np.array([[W, H, 9.0, 9.5, 4.0, 3.0]]))
        r, t = rng.normal(scale=0.5, size=3), rng.normal(size=3)
        lines.append(f"{ts} " + " ".join(f"{v:.6f}" for v in (*r, *t)))
    (base / "lowres_wide.traj").write_text("\n".join(lines))


def _dycheck(root, rng):
    (root / "scene.json").write_text(json.dumps(
        {"center": [0.1, 0.2, 0.3], "scale": 2.0, "near": 0.1, "far": 4.0}))
    names = ["0_00000", "0_00001", "0_00002"]
    (root / "metadata.json").write_text(json.dumps(
        {n: {"warp_id": 2 * i, "camera_id": 0} for i, n in enumerate(names)}))
    (root / "splits").mkdir()
    (root / "splits" / "train.json").write_text(json.dumps(
        {"frame_names": names, "time_ids": [0, 2, 4]}))
    (root / "camera").mkdir()
    for n in names:
        (root / "camera" / f"{n}.json").write_text(json.dumps({
            "orientation": _rotation(rng).tolist(), "position": rng.normal(size=3).tolist(),
            "focal_length": 50.0, "pixel_aspect_ratio": 1.01, "principal_point": [4.0, 3.0],
            "image_size": [W, H]}))
        _png(root / "rgb" / "1x" / f"{n}.png")


def _sitcoms3d(root, rng):
    intr = np.eye(3)
    intr[0, 0], intr[1, 1], intr[0, 2], intr[1, 2] = 100.0, 101.0, 4.0, 3.0
    frames = [{"image_name": f"f{i}.jpg", "intrinsics": intr.tolist(),
               "camtoworld": _pose(rng).tolist(), "width": W, "height": H} for i in range(2)]
    frames[1].pop("width")
    (root / "cameras.json").write_text(json.dumps(
        {"bbox": [[-2, -1, -1], [2, 1.5, 1]], "frames": frames}))
    for i in range(2):
        _png(root / "images_4" / f"f{i}.jpg")


def _nerfosr(root, rng):
    k = np.eye(4)
    k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 60.0, 61.0, 4.0, 3.0
    for split, n in (("train", 3), ("validation", 2), ("test", 1)):
        for d in ("intrinsics", "pose"):
            (root / split / d).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            np.savetxt(root / split / "intrinsics" / f"{i:02d}.txt", k.reshape(1, -1))
            pose = _pose(rng)
            pose[:3, 2] = -np.abs(pose[:3, 2])  # every camera looks down -z ...
            pose[:3, 3] = -3 * pose[:3, 2] + rng.normal(scale=0.1, size=3)  # ... at the origin
            pose[:3, 1] = np.cross(pose[:3, 2], pose[:3, 0])
            np.savetxt(root / split / "pose" / f"{i:02d}.txt", pose.reshape(1, -1))
            _png(root / split / "rgb" / f"{i:02d}.png")


def _nuscenes(root, rng, n_samples=12):
    (root / "v1.0-mini").mkdir(parents=True)
    samples, sds, css, egos = [], [], [], []
    for i in range(n_samples):
        fn = f"samples/CAM_FRONT/img_{i}.jpg"
        _png(root / fn, 16, 12)
        samples.append({"token": f"s{i}", "scene_token": "sc0", "timestamp": 1000 + i,
                        "data": {"CAM_FRONT": f"sd{i}"}})
        sds.append({"token": f"sd{i}", "filename": fn, "calibrated_sensor_token": f"cs{i}",
                    "ego_pose_token": f"ep{i}", "width": 16, "height": 12})
        q = rng.normal(size=4)
        css.append({"token": f"cs{i}", "rotation": (q / np.linalg.norm(q)).tolist(),
                    "translation": [1.5, 0.0, 1.6],
                    "camera_intrinsic": [[12.0, 0, 8.0], [0, 12.0, 6.0], [0, 0, 1]]})
        egos.append({"token": f"ep{i}", "rotation": [1.0, 0.0, 0.0, 0.0],
                     "translation": [2.0 * i, 0.3 * i, 0.0]})
    v = root / "v1.0-mini"
    (v / "scene.json").write_text(json.dumps([{"token": "sc0", "name": "scene-0001"}]))
    (v / "sample.json").write_text(json.dumps(samples))
    (v / "sample_data.json").write_text(json.dumps(sds))
    (v / "calibrated_sensor.json").write_text(json.dumps(css))
    (v / "ego_pose.json").write_text(json.dumps(egos))


LAYOUTS = {
    "blender": (_blender, "", [{"split": "train"}, {"split": "val"}]),
    "instant-ngp": (_instant_ngp, "", [{}]),
    "minimal": (_minimal, "MinimalParser", [{}]),
    "scannet": (_scannet, "ScannetParser", [{"split": "train"}, {"split": "val"}]),
    "sdfstudio": (_sdfstudio, "SdfstudioParser", [{}]),
    "arkitscenes": (_arkitscenes, "ARKitScenesParser", [{"split": "train"}, {"split": "val"}]),
    "dycheck": (_dycheck, "DycheckParser", [{}]),
    "sitcoms3d": (_sitcoms3d, "Sitcoms3DParser", [{}, {"include_semantics": True}]),
    "nerfosr": (_nerfosr, "", [{"split": "train"}, {"split": "val"}, {"split": "test"}]),
    "nuscenes": (_nuscenes, "NuScenesParser", [{}, {"split": "val"}, {"mask_dir": Path("m")}]),
}
"""name -> (layout builder, the parser auto-detection picks ("" where the
layout has no marker of its own), parser keyword sets to compare)."""


def build(name: str, root: Path, seed: int = 0) -> Path:
    """Write `name`'s fixture layout under root / <name> (the ARKitScenes
    video id for arkitscenes) and return its directory."""
    d = Path(root) / ("41069021" if name == "arkitscenes" else name)
    d.mkdir(parents=True)
    LAYOUTS[name][0](d, np.random.default_rng(seed))
    return d


def assert_outputs_equal(got, want):
    assert [str(p) for p in got.image_filenames] == [str(p) for p in want.image_filenames]
    assert len(got.cameras) == len(want.cameras) > 0
    for a, b in zip(got.cameras, want.cameras):
        assert (a.fx, a.fy, a.cx, a.cy, a.width, a.height, a.camera_type) == \
            (b.fx, b.fy, b.cx, b.cy, b.width, b.height, b.camera_type)
        assert a.camera_to_world.dtype == b.camera_to_world.dtype
        np.testing.assert_array_equal(a.camera_to_world, b.camera_to_world)
        np.testing.assert_array_equal(a.distortion, b.distortion)
    assert got.dataparser_scale == want.dataparser_scale
    np.testing.assert_array_equal(got.dataparser_transform, want.dataparser_transform)
    assert set(got.metadata) == set(want.metadata)
    for k, v in want.metadata.items():
        if isinstance(v, list) and v and isinstance(v[0], Path):
            assert [str(p) for p in got.metadata[k]] == [str(p) for p in v], k
        else:
            np.testing.assert_array_equal(np.asarray(got.metadata[k], dtype=object),
                                          np.asarray(v, dtype=object), err_msg=k)
    assert (got.mask_filenames is None) == (want.mask_filenames is None)
    if want.mask_filenames is not None:
        assert [str(p) for p in got.mask_filenames] == [str(p) for p in want.mask_filenames]


@pytest.fixture(scope="module")
def jzoo():
    from gaussiangrasper_tpu.data.dataparsers import zoo

    return zoo


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_parser_matches_jax(name, jzoo, tmp_path):
    root = build(name, tmp_path)
    for kw in LAYOUTS[name][2]:
        got = PARSERS[name](root, **kw).parse()
        want = jzoo.PARSERS[name](root, **kw).parse()
        assert_outputs_equal(got, want)


def test_parser_registry_matches_jax(jzoo, tmp_path):
    assert set(PARSERS) == set(jzoo.PARSERS)
    with pytest.raises(SystemExit) as got:
        PARSERS["phototourism-raw"](tmp_path).parse()
    with pytest.raises(SystemExit) as want:
        jzoo.PARSERS["phototourism-raw"](tmp_path).parse()
    assert str(got.value) == str(want.value) and "image downloads" in str(got.value)
    with pytest.raises(FileNotFoundError):
        PARSERS["nuscenes"](tmp_path).parse()
    with pytest.raises(KeyError, match="unknown dataparser"):
        resolve_parser(tmp_path, "nope")


def test_nuscenes_scene_selection_matches_jax(jzoo, tmp_path):
    root = tmp_path / "nusc"
    _nuscenes(root, np.random.default_rng(3), n_samples=10)
    for kw in ({"scene": "scene-0001"}, {"split": "val"}):
        assert_outputs_equal(PARSERS["nuscenes"](root, **kw).parse(),
                             jzoo.PARSERS["nuscenes"](root, **kw).parse())
    for zoo in (jzoo, None):
        with pytest.raises(KeyError):
            (zoo.PARSERS if zoo else PARSERS)["nuscenes"](root, scene="scene-9999").parse()
        with pytest.raises(ValueError):
            (zoo.PARSERS if zoo else PARSERS)["nuscenes"](root, split="bogus").parse()


def test_blender_focal_from_the_png_header(tmp_path):
    root = build("blender", tmp_path)
    cam = PARSERS["blender"](root).parse().cameras[0]
    assert cam.width == W and abs(cam.fx - 0.5 * W / math.tan(0.4)) < 1e-9


@pytest.mark.parametrize("name", [n for n, (_, p, _) in LAYOUTS.items() if p])
def test_auto_detection_matches_jax(name, jzoo, tmp_path):
    root = build(name, tmp_path)
    got, want = resolve_parser(root), jzoo.resolve_parser(root)
    assert type(got).__name__ == type(want).__name__ == LAYOUTS[name][1]
    assert_outputs_equal(got.parse(), want.parse())


@pytest.mark.parametrize("pair", [("dycheck", "sitcoms3d"), ("sitcoms3d", "minimal"),
                                  ("sdfstudio", "dycheck"), ("scannet", "minimal")])
def test_auto_detection_order_with_two_markers(pair, jzoo, tmp_path):
    """A directory holding two layouts' markers: the JAX order decides."""
    root = tmp_path / "both"
    root.mkdir()
    for i, name in enumerate(pair):
        LAYOUTS[name][0](root, np.random.default_rng(i))
    got, want = resolve_parser(root), jzoo.resolve_parser(root)
    assert type(got).__name__ == type(want).__name__ == LAYOUTS[pair[0]][1]
