"""Readers for the public COLMAP sparse-reconstruction formats (a copy of
the JAX package's data/colmap_io.py, numpy only).

The documented COLMAP binary/text layouts (cameras, images, points3D),
written from the format spec; host-side only.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

# COLMAP camera model ids -> (name, num_params), per the public model table.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific

    def intrinsics(self) -> Tuple[float, float, float, float]:
        """(fx, fy, cx, cy)."""
        p = self.params
        if self.model == "SIMPLE_PINHOLE" or self.model.startswith("SIMPLE_RADIAL") \
                or self.model in ("RADIAL", "RADIAL_FISHEYE"):
            return float(p[0]), float(p[0]), float(p[1]), float(p[2])
        # PINHOLE/OPENCV*/FULL_OPENCV/THIN_PRISM/FOV: (fx, fy, cx, cy, ...)
        return float(p[0]), float(p[1]), float(p[2]), float(p[3])

    def distortion(self) -> np.ndarray:
        """OpenCV-convention (k1, k2, p1, p2, k3, k4) where available."""
        p = self.params
        d = np.zeros(6)
        if self.model == "SIMPLE_RADIAL":
            d[0] = p[3]
        elif self.model == "RADIAL":
            d[:2] = p[3:5]
        elif self.model == "OPENCV":
            d[:4] = p[4:8]
        elif self.model == "OPENCV_FISHEYE":
            d[[0, 1, 4, 5]] = p[4:8]
        elif self.model == "FULL_OPENCV":
            d[:4] = p[4:8]
            d[4] = p[8]
        return d


@dataclass
class ColmapImage:
    qvec: np.ndarray  # (4,) w,x,y,z world-to-camera rotation
    tvec: np.ndarray  # (3,) world-to-camera translation
    camera_id: int
    name: str


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _read(fh, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, fh.read(size))


def read_cameras_binary(path: Path) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(fh, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(fh, f"<{n_params}d"))
            out[cam_id] = ColmapCamera(name, int(width), int(height), params)
    return out


def read_cameras_text(path: Path) -> Dict[int, ColmapCamera]:
    out = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cam_id, model = int(parts[0]), parts[1]
        out[cam_id] = ColmapCamera(
            model, int(parts[2]), int(parts[3]), np.array([float(x) for x in parts[4:]])
        )
    return out


def read_images_binary(path: Path) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            img_id = _read(fh, "<i")[0]
            qvec = np.array(_read(fh, "<4d"))
            tvec = np.array(_read(fh, "<3d"))
            cam_id = _read(fh, "<i")[0]
            name = b""
            while True:
                c = fh.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(fh, "<Q")
            fh.read(24 * n_pts)  # skip 2D points (x, y, point3D_id)
            out[img_id] = ColmapImage(qvec, tvec, cam_id, name.decode())
    return out


def read_images_text(path: Path) -> Dict[int, ColmapImage]:
    out = {}
    # pose lines strictly alternate with 2D-point lines, and a points line
    # may be EMPTY (zero observations) — so blank lines must count toward
    # the alternation rather than being stripped first.
    expecting_pose = True
    for raw in open(path):
        line = raw.rstrip("\n")
        if line.strip().startswith("#"):
            continue
        if expecting_pose:
            if not line.strip():
                continue  # leading/trailing blank outside the alternation
            p = line.split()
            out[int(p[0])] = ColmapImage(
                qvec=np.array([float(x) for x in p[1:5]]),
                tvec=np.array([float(x) for x in p[5:8]]),
                camera_id=int(p[8]),
                name=p[9],
            )
            expecting_pose = False
        else:
            expecting_pose = True  # consumed the (possibly empty) points line
    return out


def read_points3d_binary(path: Path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (xyz (N,3) float64, rgb (N,3) uint8, error (N,))."""
    xyzs, rgbs, errs = [], [], []
    with open(path, "rb") as fh:
        (n,) = _read(fh, "<Q")
        for _ in range(n):
            data = _read(fh, "<Q3d3Bd")
            xyzs.append(data[1:4])
            rgbs.append(data[4:7])
            errs.append(data[7])
            (track_len,) = _read(fh, "<Q")
            fh.read(8 * track_len)  # (image_id, point2D_idx) pairs
    return (
        np.array(xyzs, np.float64).reshape(-1, 3),
        np.array(rgbs, np.uint8).reshape(-1, 3),
        np.array(errs, np.float64),
    )


def read_points3d_text(path: Path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyzs, rgbs, errs = [], [], []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        p = line.split()
        xyzs.append([float(x) for x in p[1:4]])
        rgbs.append([int(x) for x in p[4:7]])
        errs.append(float(p[7]))
    return (
        np.array(xyzs, np.float64).reshape(-1, 3),
        np.array(rgbs, np.uint8).reshape(-1, 3),
        np.array(errs, np.float64),
    )


def write_cameras_text(path: Path, cameras: Dict[int, ColmapCamera]) -> None:
    with open(path, "w") as fh:
        fh.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        for cid, c in cameras.items():
            params = " ".join(f"{float(x):.17g}" for x in c.params)
            fh.write(f"{cid} {c.model} {c.width} {c.height} {params}\n")


def write_images_text(path: Path, images: Dict[int, ColmapImage]) -> None:
    with open(path, "w") as fh:
        fh.write("# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n")
        for iid, im in images.items():
            q = " ".join(f"{float(x):.17g}" for x in im.qvec)
            t = " ".join(f"{float(x):.17g}" for x in im.tvec)
            fh.write(f"{iid} {q} {t} {im.camera_id} {im.name}\n\n")


def write_points3d_text(path: Path, xyz: np.ndarray, rgb: np.ndarray) -> None:
    with open(path, "w") as fh:
        fh.write("# 3D point list: POINT3D_ID X Y Z R G B ERROR TRACK[]\n")
        for i, (p, c) in enumerate(zip(xyz, rgb)):
            fh.write(
                f"{i + 1} {float(p[0]):.17g} {float(p[1]):.17g} {float(p[2]):.17g} {int(c[0])} {int(c[1])} {int(c[2])} 0.0\n"
            )
