"""Capture ingestion: images / video / polycam / record3d / metashape /
realitycapture / odm / equirect -> a trainable dataset (counterpart of the
JAX package's scripts/process_data.py, the ns-process-data analog).

The same subcommands, layouts and transforms.json as the JAX CLI, without
Pillow or OpenCV: frames are read by `utils/image_io.read_image`, resized
by `resize_bilinear` (Pillow's BILINEAR, bit for bit), cropped by slicing
and written by suffix as Pillow's `save` writes them (`write_png`, or
`write_jpeg` at quality 75: Pillow's bytes); equirect crops are resampled
by `data/equirect.py` on --device (the card unless cpu) and written as
cv2.imwrite writes them. Files the JAX CLI copies are copied. `colmap`,
`ffmpeg` and the hloc toolbox stay optional: without them the CLI prints
the same hint or raises the same SystemExit as the JAX CLI.

Subcommands:
  images   copy + downscale (x2/x4/x8) and, when a COLMAP reconstruction
           is present, convert it to transforms.json (the OpenCV->OpenGL
           flip + [1,0,2] row permute + z-negate).
  video    ffmpeg frame extraction, then the same pipeline; needs ffmpeg.
  polycam  a Polycam export's keyframes -> transforms.json (blur-score
           filtering, border crop, the [t_2*, t_0*, t_1*] row order).
  record3d, metashape, realitycapture, odm, equirect: as in the JAX CLI.

    python -m gaussiangrasper_torch.scripts.process_data images --data DIR --output OUT
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
from pathlib import Path

import numpy as np

from gaussiangrasper_torch._device import resolve_device
from gaussiangrasper_torch.utils.image_io import (image_size, read_image, resize_bilinear,
                                                  write_jpeg, write_png)

DOWNSCALES = (2, 4, 8)


def save_image(path: Path, img: np.ndarray) -> None:
    """Write by suffix, as Pillow's `save` chooses: PNG, or JPEG at
    Pillow's default quality 75."""
    if path.suffix.lower() == ".png":
        write_png(path, img)
    elif path.suffix.lower() in (".jpg", ".jpeg"):
        write_jpeg(path, img, quality=75)
    else:
        raise ValueError(f"{path}: only .png, .jpg and .jpeg frames are written")


def _downscale(image_dir: Path) -> None:
    """images/ -> images_2/, images_4/, images_8/ (the reference's
    downscale convention consumed by its nerfstudio dataparser), each frame
    resized by Pillow's bilinear filter (`resize_bilinear`)."""
    files = sorted(
        p for p in image_dir.iterdir()
        if p.suffix.lower() in (".png", ".jpg", ".jpeg")
    )
    for d in DOWNSCALES:
        out = image_dir.parent / f"images_{d}"
        out.mkdir(exist_ok=True)
        for f in files:
            img = read_image(f)
            h, w = img.shape[:2]
            save_image(out / f.name, resize_bilinear(img, max(w // d, 1), max(h // d, 1)))


def colmap_to_transforms(recon_dir: Path, output_dir: Path) -> int:
    """COLMAP model -> transforms.json (ref colmap_utils.colmap_to_json)."""
    from gaussiangrasper_torch.data import colmap_io as cio

    cams = (
        cio.read_cameras_binary(recon_dir / "cameras.bin")
        if (recon_dir / "cameras.bin").exists()
        else cio.read_cameras_text(recon_dir / "cameras.txt")
    )
    images = (
        cio.read_images_binary(recon_dir / "images.bin")
        if (recon_dir / "images.bin").exists()
        else cio.read_images_text(recon_dir / "images.txt")
    )
    frames = []
    for im_id, im in sorted(images.items()):
        r = cio.qvec_to_rotmat(im.qvec)
        w2c = np.eye(4)
        w2c[:3, :3] = r
        w2c[:3, 3] = im.tvec
        c2w = np.linalg.inv(w2c)
        c2w[0:3, 1:3] *= -1            # OpenCV -> OpenGL
        c2w = c2w[np.array([1, 0, 2, 3]), :]  # COLMAP world -> ours
        c2w[2, :] *= -1
        frames.append({
            "file_path": f"./images/{im.name}",
            "transform_matrix": c2w.tolist(),
            "colmap_im_id": im_id,
        })
    cam = cams[min(cams)]
    fx, fy, cx, cy = cam.intrinsics()
    out = {
        "w": cam.width, "h": cam.height,
        "fl_x": float(fx), "fl_y": float(fy),
        "cx": float(cx), "cy": float(cy),
        "camera_model": "OPENCV",
        "frames": frames,
    }
    applied = np.eye(4)[:3][np.array([1, 0, 2]), :]
    applied[2, :] *= -1
    out["applied_transform"] = applied.tolist()
    (output_dir / "transforms.json").write_text(json.dumps(out, indent=4))
    return len(frames)


def process_images(data: Path, output: Path, skip_downscale: bool = False) -> None:
    output.mkdir(parents=True, exist_ok=True)
    img_out = output / "images"
    img_out.mkdir(exist_ok=True)
    if Path(data).resolve() != img_out.resolve():
        for f in sorted(Path(data).iterdir()):
            if f.suffix.lower() in (".png", ".jpg", ".jpeg"):
                shutil.copy2(f, img_out / f.name)
    if not skip_downscale:
        _downscale(img_out)
    # convert an existing reconstruction; else hint at COLMAP
    for sub in ("sparse/0", "colmap/sparse/0", "sparse"):
        recon = Path(data) / sub
        if (recon / "cameras.bin").exists() or (recon / "cameras.txt").exists():
            n = colmap_to_transforms(recon, output)
            print(f"converted COLMAP model ({n} frames) -> transforms.json")
            return
    if shutil.which("colmap") is None:
        print(
            "no COLMAP reconstruction found and no `colmap` binary on PATH; "
            "images were copied + downscaled. Provide a sparse model or use "
            "scripts/generate_data.py for RGB-D captures."
        )
    else:
        print(
            "no COLMAP reconstruction found — images were copied + "
            "downscaled WITHOUT poses. Run "
            f"`colmap automatic_reconstructor --workspace_path {output} "
            f"--image_path {output / 'images'}` and re-run this command "
            "to convert the model to transforms.json."
        )


def process_video(data: Path, output: Path, num_frames: int = 300) -> None:
    """Extract ~num_frames equally-spaced frames (the reference's
    convert_video_to_images: spacing = total // num_frames,
    process_data_utils.py)."""
    if shutil.which("ffmpeg") is None:
        raise SystemExit(
            "`ffmpeg` is not available in this image; extract frames "
            "elsewhere and run the `images` subcommand."
        )
    output.mkdir(parents=True, exist_ok=True)
    img_out = output / "images"
    img_out.mkdir(exist_ok=True)
    # extract every frame, then prune to num_frames equally spaced —
    # robust to containers where ffprobe cannot report a frame count
    subprocess.run(
        ["ffmpeg", "-i", str(data), "-vsync", "vfr",
         str(img_out / "frame_%05d.png")],
        check=True,
    )
    frames = sorted(img_out.glob("frame_*.png"))
    if len(frames) > num_frames:
        keep = set(
            np.linspace(0, len(frames) - 1, num_frames).astype(int).tolist()
        )
        for i, f in enumerate(frames):
            if i not in keep:
                f.unlink()
    process_images(img_out, output, skip_downscale=False)


def polycam_to_transforms(
    image_dir: Path, cameras_dir: Path, output_dir: Path,
    min_blur_score: float = 25.0, crop_border_pixels: int = 15,
) -> int:
    """Polycam keyframes -> transforms.json (ref polycam_utils.polycam_to_json)."""
    frames = []
    skipped = 0
    for img in sorted(image_dir.iterdir()):
        cam_json = cameras_dir / f"{img.stem}.json"
        if not cam_json.exists():
            continue
        fj = json.loads(cam_json.read_text())
        if "blur_score" in fj and fj["blur_score"] < min_blur_score:
            skipped += 1
            continue
        frame = {
            "fl_x": fj["fx"], "fl_y": fj["fy"],
            "cx": fj["cx"] - crop_border_pixels,
            "cy": fj["cy"] - crop_border_pixels,
            "w": fj["width"] - crop_border_pixels * 2,
            "h": fj["height"] - crop_border_pixels * 2,
            "file_path": f"./images/{img.name}",
            # Polycam row order -> OpenGL (ref polycam_utils.py:73-78)
            "transform_matrix": [
                [fj["t_20"], fj["t_21"], fj["t_22"], fj["t_23"]],
                [fj["t_00"], fj["t_01"], fj["t_02"], fj["t_03"]],
                [fj["t_10"], fj["t_11"], fj["t_12"], fj["t_13"]],
                [0.0, 0.0, 0.0, 1.0],
            ],
        }
        frames.append(frame)
    output_dir.mkdir(parents=True, exist_ok=True)
    (output_dir / "transforms.json").write_text(
        json.dumps({"camera_model": "OPENCV", "frames": frames}, indent=4)
    )
    if skipped:
        print(f"skipped {skipped} frames below blur score {min_blur_score}")
    return len(frames)


def process_polycam(data: Path, output: Path, min_blur_score: float,
                    crop_border_pixels: int) -> None:
    base = Path(data)
    if (base / "keyframes").exists():
        base = base / "keyframes"
    image_dir = base / "corrected_images"
    cameras_dir = base / "corrected_cameras"
    if not image_dir.exists():
        image_dir = base / "images"
        cameras_dir = base / "cameras"
    output.mkdir(parents=True, exist_ok=True)
    img_out = output / "images"
    img_out.mkdir(exist_ok=True)
    for f in sorted(image_dir.iterdir()):
        if f.suffix.lower() not in (".png", ".jpg", ".jpeg"):
            continue
        if crop_border_pixels:
            b = crop_border_pixels
            img = read_image(f)
            save_image(img_out / f.name,
                       np.ascontiguousarray(img[b:img.shape[0] - b, b:img.shape[1] - b]))
        else:
            shutil.copy2(f, img_out / f.name)
    n = polycam_to_transforms(image_dir, cameras_dir, output,
                              min_blur_score, crop_border_pixels)
    print(f"wrote transforms.json with {n} frames")


def _quat_xyzw_to_rotmat(q: np.ndarray) -> np.ndarray:
    """Scalar-last (x, y, z, w) quaternions -> rotation matrices (N, 3, 3)
    (Record3D's convention, ref record3d_utils.py:46-49)."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


def process_record3d(data: Path, output: Path, max_images: int = 300) -> None:
    """Record3D export (rgb/*.jpg numbered frames + metadata.json with
    scalar-last pose quaternions and a column-major K) -> transforms.json
    (ref record3d_utils.record3d_to_json:28-93 + scripts/process_data.py:
    60-105 for the rgb/ layout and even subsampling)."""
    data = Path(data)
    img_dir = data / "rgb"
    if not img_dir.exists():
        raise SystemExit(f"Record3D image directory {img_dir} doesn't exist")
    files = sorted(
        (f for f in img_dir.iterdir()
         if f.stem.isdigit()
         and f.suffix.lower() in (".jpg", ".jpeg", ".png", ".tif", ".tiff")),
        key=lambda f: int(f.stem),
    )
    idx = np.arange(len(files))
    if max_images != -1 and len(files) > max_images:
        idx = np.round(np.linspace(0, len(files) - 1, max_images)).astype(int)
        files = [files[i] for i in idx]

    meta = json.loads((data / "metadata.json").read_text())
    poses = np.asarray(meta["poses"], np.float64)  # (N, 7): qx qy qz qw + t
    rot = _quat_xyzw_to_rotmat(poses[:, :4])
    c2w = np.concatenate([rot, poses[:, 4:, None]], axis=-1)[idx]

    output.mkdir(parents=True, exist_ok=True)
    img_out = output / "images"
    img_out.mkdir(exist_ok=True)
    frames = []
    for i, f in enumerate(files):
        shutil.copy2(f, img_out / f.name)
        m = np.eye(4)
        m[:3] = c2w[i]
        frames.append({
            "file_path": f"images/{f.name}",
            "transform_matrix": m.tolist(),
        })
    k = np.asarray(meta["K"], np.float64).reshape(3, 3).T  # column-major
    out = {
        "fl_x": float(k[0, 0]), "fl_y": float(k[0, 0]),
        # the reference uses the image center (its principal-point note,
        # record3d_utils.py:74-76)
        "cx": meta["w"] / 2.0, "cy": meta["h"] / 2.0,
        "w": meta["w"], "h": meta["h"],
        "camera_model": "OPENCV",
        "frames": frames,
    }
    (output / "transforms.json").write_text(json.dumps(out, indent=4))
    _downscale(img_out)
    print(f"wrote transforms.json with {len(frames)} frames")


def _xml_float(node, name: str) -> float:
    child = node.find(name)
    return float(child.text) if child is not None else 0.0


def process_metashape(data: Path, xml: Path, output: Path) -> None:
    """Agisoft Metashape cameras.xml + images -> transforms.json
    (ref metashape_utils.metashape_to_json:35-201: per-sensor intrinsics
    with cx/cy offsets from the image center, component transforms with
    scale-normalized translation, the [2,0,1] row permute + y/z column
    negation into the OpenGL world)."""
    import xml.etree.ElementTree as ET

    root = ET.parse(xml).getroot()
    chunk = root[0]
    sensors = chunk.find("sensors")
    if sensors is None:
        raise SystemExit("no <sensors> in Metashape xml")
    model_of = {"frame": "OPENCV", "fisheye": "OPENCV_FISHEYE",
                "spherical": "EQUIRECTANGULAR"}
    sensor_dict = {}
    cam_model = None
    for sensor in sensors:
        stype = sensor.get("type")
        calib = sensor.find("calibration")
        if stype != "spherical" and calib is None:
            continue
        if cam_model is None:
            cam_model = model_of.get(stype)
        if model_of.get(stype) != cam_model:
            raise SystemExit("mixed Metashape sensor types are unsupported")
        res = sensor.find("resolution")
        s = {"w": int(res.get("width")), "h": int(res.get("height"))}
        if calib is None:  # spherical
            s.update(fl_x=s["w"] / 2.0, fl_y=float(s["h"]),
                     cx=s["w"] / 2.0, cy=s["h"] / 2.0)
        else:
            f = _xml_float(calib, "f")
            s.update(
                fl_x=f, fl_y=f,
                cx=_xml_float(calib, "cx") + s["w"] / 2.0,
                cy=_xml_float(calib, "cy") + s["h"] / 2.0,
                k1=_xml_float(calib, "k1"), k2=_xml_float(calib, "k2"),
                k3=_xml_float(calib, "k3"), k4=_xml_float(calib, "k4"),
                p1=_xml_float(calib, "p1"), p2=_xml_float(calib, "p2"),
            )
        sensor_dict[sensor.get("id")] = s
    if not sensor_dict:
        raise SystemExit("no calibrated sensor found in Metashape xml")

    component_dict = {}
    components = chunk.find("components")
    if components is not None:
        for comp in components:
            tr = comp.find("transform")
            if tr is None:
                continue
            rot = tr.find("rotation")
            r = (np.array([float(x) for x in rot.text.split()]).reshape(3, 3)
                 if rot is not None else np.eye(3))
            tl = tr.find("translation")
            t = (np.array([float(x) for x in tl.text.split()])
                 if tl is not None else np.zeros(3))
            sc = tr.find("scale")
            s = float(sc.text) if sc is not None else 1.0
            m = np.eye(4)
            m[:3, :3] = r
            m[:3, 3] = t / s
            component_dict[comp.get("id")] = m

    data = Path(data)
    output.mkdir(parents=True, exist_ok=True)
    img_out = output / "images"
    img_out.mkdir(exist_ok=True)
    stem_map = {}
    for f in sorted(data.iterdir()) if data.is_dir() else []:
        if f.suffix.lower() in (".png", ".jpg", ".jpeg", ".tif", ".tiff"):
            shutil.copy2(f, img_out / f.name)
            stem_map[f.stem] = f.name

    frames, skipped = [], 0
    cameras = chunk.find("cameras")
    for camera in (cameras if cameras is not None else []):
        label = camera.get("label") or ""
        if label not in stem_map:
            label = label.split(".")[0]
        if label not in stem_map:
            skipped += 1
            continue
        sensor = sensor_dict.get(camera.get("sensor_id"))
        tr = camera.find("transform")
        if sensor is None or tr is None:
            skipped += 1
            continue
        m = np.array([float(x) for x in tr.text.split()]).reshape(4, 4)
        comp = component_dict.get(camera.get("component_id"))
        if comp is not None:
            m = comp @ m
        m = m[[2, 0, 1, 3], :]  # Metashape world -> OpenGL world
        m[:, 1:3] *= -1
        frames.append({
            "file_path": f"images/{stem_map[label]}",
            "transform_matrix": m.tolist(),
            **sensor,
        })
    (output / "transforms.json").write_text(json.dumps(
        {"camera_model": cam_model, "frames": frames}, indent=4
    ))
    msg = f"wrote transforms.json with {len(frames)} frames"
    if skipped:
        msg += f" ({skipped} cameras skipped: missing image or pose)"
    print(msg)


def process_realitycapture(data: Path, csv_file: Path, output: Path) -> None:
    """RealityCapture CSV export (#name,x,y,alt,heading,pitch,roll,f,px,py,
    k1..k4,t1,t2) + images -> transforms.json (ref realitycapture_utils.py:
    29-127: 35mm-equivalent focal scaled by max(w,h)/36, Euler z@-heading
    x@pitch y@roll rotation, orientation_override="none")."""
    import csv as csv_mod

    data = Path(data)
    output.mkdir(parents=True, exist_ok=True)
    img_out = output / "images"
    img_out.mkdir(exist_ok=True)
    stem_map = {}
    for f in sorted(data.iterdir()) if data.is_dir() else []:
        if f.suffix.lower() in (".png", ".jpg", ".jpeg", ".tif", ".tiff"):
            shutil.copy2(f, img_out / f.name)
            stem_map[f.stem] = f.name

    with open(csv_file, encoding="utf-8") as fh:
        rows = list(csv_mod.DictReader(fh))

    def euler(yaw, pitch, roll):
        sy, cy = np.sin(np.deg2rad(yaw)), np.cos(np.deg2rad(yaw))
        sp, cp = np.sin(np.deg2rad(pitch)), np.cos(np.deg2rad(pitch))
        sr, cr = np.sin(np.deg2rad(roll)), np.cos(np.deg2rad(roll))
        rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        ry = np.array([[cr, 0, sr], [0, 1, 0], [-sr, 0, cr]])
        rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
        return rz @ rx @ ry

    frames, skipped = [], 0
    for row in rows:
        stem = row["#name"].rpartition(".")[0]
        if stem not in stem_map:
            skipped += 1
            continue
        w, h = image_size(img_out / stem_map[stem])
        m = np.eye(4)
        m[:3, :3] = euler(-float(row["heading"]), float(row["pitch"]),
                          float(row["roll"]))
        m[:3, 3] = [float(row["x"]), float(row["y"]), float(row["alt"])]
        frames.append({
            "file_path": f"images/{stem_map[stem]}",
            "w": w, "h": h,
            "fl_x": float(row["f"]) * max(w, h) / 36.0,
            "fl_y": float(row["f"]) * max(w, h) / 36.0,
            "cx": float(row.get("px", 0.0)) / 36.0 + w / 2.0,
            "cy": float(row.get("py", 0.0)) / 36.0 + h / 2.0,
            "k1": float(row.get("k1", 0.0)), "k2": float(row.get("k2", 0.0)),
            "k3": float(row.get("k3", 0.0)), "k4": float(row.get("k4", 0.0)),
            "p1": float(row.get("t1", 0.0)), "p2": float(row.get("t2", 0.0)),
            "transform_matrix": m.tolist(),
        })
    (output / "transforms.json").write_text(json.dumps(
        {"camera_model": "OPENCV", "orientation_override": "none",
         "frames": frames}, indent=4
    ))
    msg = f"wrote transforms.json with {len(frames)} frames"
    if skipped:
        msg += f" ({skipped} rows skipped: image missing)"
    print(msg)


def process_odm(data: Path, output: Path) -> None:
    """OpenDroneMap project (cameras.json + odm_report/shots.geojson or
    opensfm/reconstruction shots) + images/ -> transforms.json (ref
    odm_utils.cameras2nerfds:48-148: normalized focal scaled by max(w,h),
    principal point offset from the (w-1)/2 center, NEGATED Rodrigues
    world-to-cam rotation, [2,0,1] row permute + y/z negation)."""
    data = Path(data)
    cameras_file = data / "cameras.json"
    shots_file = data / "odm_report" / "shots.geojson"
    if not shots_file.exists():
        shots_file = data / "shots.geojson"
    if not cameras_file.exists() or not shots_file.exists():
        raise SystemExit(
            "ODM layout needs cameras.json and (odm_report/)shots.geojson"
        )
    cameras = json.loads(cameras_file.read_text())
    if len(cameras) != 1:
        raise SystemExit("only single-camera ODM projects are supported")
    camera = next(iter(cameras.values()))
    proj = camera["projection_type"]
    cam_model = {"brown": "OPENCV", "perspective": "OPENCV",
                 "fisheye": "OPENCV_FISHEYE", "fisheye_opencv": "OPENCV_FISHEYE",
                 "spherical": "EQUIRECTANGULAR",
                 "equirectangular": "EQUIRECTANGULAR"}.get(proj)
    if cam_model is None:
        raise SystemExit(f"unsupported ODM camera model {proj!r}")
    w, h = int(camera["width"]), int(camera["height"])
    sensor = {
        "w": w, "h": h,
        "fl_x": float(camera.get("focal_x", camera.get("focal"))) * max(w, h),
        "fl_y": float(camera.get("focal_y", camera.get("focal"))) * max(w, h),
        "cx": float(camera["c_x"]) + (w - 1.0) / 2.0,
        "cy": float(camera["c_y"]) + (h - 1.0) / 2.0,
    }
    for pname in ("k1", "k2", "p1", "p2", "k3"):
        if pname in camera:
            sensor[pname] = camera[pname]

    img_dir = data / "images"
    output.mkdir(parents=True, exist_ok=True)
    img_out = output / "images"
    img_out.mkdir(exist_ok=True)
    stem_map = {}
    if img_dir.exists():
        for f in sorted(img_dir.iterdir()):
            if f.suffix.lower() in (".png", ".jpg", ".jpeg", ".tif", ".tiff"):
                shutil.copy2(f, img_out / f.name)
                stem_map[f.stem] = f.name

    from gaussiangrasper_torch.data.dataparsers.zoo import _rodrigues

    frames, skipped = [], 0
    for shot in json.loads(shots_file.read_text())["features"]:
        props = shot["properties"]
        stem = Path(props["filename"]).stem
        if stem not in stem_map:
            skipped += 1
            continue
        m = np.eye(4)
        m[:3, :3] = _rodrigues(-np.asarray(props["rotation"], np.float64))
        m[:3, 3] = props["translation"]
        m = m[[2, 0, 1, 3], :]
        m[:, 1:3] *= -1
        frames.append({
            "file_path": f"images/{stem_map[stem]}",
            "transform_matrix": m.tolist(),
            **sensor,
        })
    (output / "transforms.json").write_text(json.dumps(
        {"camera_model": cam_model, "frames": frames}, indent=4
    ))
    msg = f"wrote transforms.json with {len(frames)} frames"
    if skipped:
        msg += f" ({skipped} shots skipped: image missing)"
    print(msg)


def process_equirect(
    data: Path,
    output: Path,
    images_per_equirect: int = 8,
    crop_factor=(0.0, 0.0, 0.0, 0.0),
    num_frames: int = 300,
    resolution: int = 0,
    device=None,
) -> None:
    """Equirectangular video/images -> perspective crops -> the normal
    images pipeline (the reference's `ns-process-data images/video
    --camera-type equirectangular` flow: compute the crop resolution from
    the pixel-count heuristic, generate 8 or 14 pinhole crops per frame,
    then hand the crops to SfM; ref process_data.py equirect branches +
    equirect_utils.py:233-338). The crops are resampled on `device` (None:
    the card)."""
    from gaussiangrasper_torch.data import equirect

    data = Path(data)
    output.mkdir(parents=True, exist_ok=True)
    if data.is_file():  # video: extract frames first
        frames_dir = output / "equirect_frames"
        frames_dir.mkdir(exist_ok=True)
        if shutil.which("ffmpeg") is None:
            raise SystemExit(
                "`ffmpeg` is not available; extract frames elsewhere and "
                "re-run with --data <frame dir>."
            )
        subprocess.run(
            ["ffmpeg", "-i", str(data), "-vsync", "vfr",
             str(frames_dir / "frame_%05d.png")],
            check=True,
        )
        frames = sorted(frames_dir.glob("frame_*.png"))
        if len(frames) > num_frames:
            keep = set(np.linspace(0, len(frames) - 1, num_frames)
                       .astype(int).tolist())
            for i, f in enumerate(frames):
                if i not in keep:
                    f.unlink()
        data = frames_dir

    first = next((f for f in sorted(data.iterdir())
                  if f.suffix.lower() in (".png", ".jpg", ".jpeg")), None)
    if first is None:
        raise SystemExit(f"no images found in {data}")
    if resolution > 0:
        out_size = (resolution, resolution)
    else:
        w, h = image_size(first)
        out_size = equirect.crop_resolution((h, w), images_per_equirect)
    crops = equirect.generate_planar_projections(
        data, out_size, images_per_equirect, crop_factor, device=resolve_device(device)
    )
    process_images(crops, output, skip_downscale=False)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Process raw captures into trainable datasets "
                    "(the ns-process-data analog)"
    )
    sub = p.add_subparsers(dest="mode", required=True)
    pi = sub.add_parser("images")
    pi.add_argument("--data", type=Path, required=True)
    pi.add_argument("--output", type=Path, required=True)
    pi.add_argument("--skip-downscale", action="store_true")
    pv = sub.add_parser("video")
    pv.add_argument("--data", type=Path, required=True)
    pv.add_argument("--output", type=Path, required=True)
    pv.add_argument("--num-frames", type=int, default=300)
    pp = sub.add_parser("polycam")
    pp.add_argument("--data", type=Path, required=True)
    pp.add_argument("--output", type=Path, required=True)
    pp.add_argument("--min-blur-score", type=float, default=25.0)
    pp.add_argument("--crop-border-pixels", type=int, default=15)
    pr = sub.add_parser("record3d")
    pr.add_argument("--data", type=Path, required=True)
    pr.add_argument("--output", type=Path, required=True)
    pr.add_argument("--max-images", type=int, default=300)
    pm = sub.add_parser("metashape")
    pm.add_argument("--data", type=Path, required=True,
                    help="directory of source images")
    pm.add_argument("--xml", type=Path, required=True,
                    help="Metashape cameras.xml export")
    pm.add_argument("--output", type=Path, required=True)
    prc = sub.add_parser("realitycapture")
    prc.add_argument("--data", type=Path, required=True,
                     help="directory of source images")
    prc.add_argument("--csv", type=Path, required=True,
                     help="RealityCapture internal/external params CSV")
    prc.add_argument("--output", type=Path, required=True)
    po = sub.add_parser("odm")
    po.add_argument("--data", type=Path, required=True,
                    help="ODM project root (cameras.json, images/, odm_report/)")
    po.add_argument("--output", type=Path, required=True)
    ph = sub.add_parser("hloc")
    ph.add_argument("--data", type=Path, required=True)
    ph.add_argument("--output", type=Path, required=True)
    pe = sub.add_parser("equirect")
    pe.add_argument("--data", type=Path, required=True,
                    help="equirectangular video file or image directory")
    pe.add_argument("--output", type=Path, required=True)
    pe.add_argument("--images-per-equirect", type=int, default=8,
                    choices=(8, 14))
    pe.add_argument("--crop-factor", type=float, nargs=4,
                    default=(0.0, 0.0, 0.0, 0.0),
                    metavar=("TOP", "BOTTOM", "LEFT", "RIGHT"))
    pe.add_argument("--num-frames", type=int, default=300)
    pe.add_argument("--resolution", type=int, default=0,
                    help="crop edge in px (0 = pixel-count heuristic)")
    pe.add_argument("--device", default="cuda",
                    help="where the crops are resampled: cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.mode == "hloc":
        # the reference's hloc backend (process_data/hloc_utils.py) drives
        # the Hierarchical-Localization toolbox, an external SDK this
        # image does not ship — the install-hint gate mirrors the
        # reference's ImportError message (hloc_utils.py:32-44)
        raise SystemExit(
            "the hloc backend needs the Hierarchical-Localization toolbox "
            "(github.com/cvg/Hierarchical-Localization), which is not "
            "installed. Use the `images` subcommand with a COLMAP "
            "reconstruction instead."
        )

    if args.mode == "images":
        process_images(args.data, args.output, args.skip_downscale)
    elif args.mode == "video":
        process_video(args.data, args.output, args.num_frames)
    elif args.mode == "polycam":
        process_polycam(args.data, args.output, args.min_blur_score,
                        args.crop_border_pixels)
    elif args.mode == "record3d":
        process_record3d(args.data, args.output, args.max_images)
    elif args.mode == "metashape":
        process_metashape(args.data, args.xml, args.output)
    elif args.mode == "realitycapture":
        process_realitycapture(args.data, args.csv, args.output)
    elif args.mode == "equirect":
        process_equirect(args.data, args.output, args.images_per_equirect,
                         tuple(args.crop_factor), args.num_frames,
                         args.resolution, args.device)
    else:
        process_odm(args.data, args.output)


if __name__ == "__main__":
    main()
