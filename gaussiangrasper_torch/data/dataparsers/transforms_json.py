"""transforms.json dataparser (nerfstudio / Blender-style; a copy of the
JAX package's data/dataparsers/transforms_json.py, with the image-size probe
reading the PNG header instead of opening the image with Pillow).

Covers nerfstudio's NerfstudioDataParser and BlenderDataParser surface
for the fields the GS pipeline consumes (per-frame or global intrinsics,
c2w matrices, optional ply/seed points). Handles both the Blender
`camera_angle_x` convention and explicit fl_x/fl_y intrinsics.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from gaussiangrasper_torch.data.dataparsers.base import (
    DataparserOutputs,
    ParsedCamera,
    apply_transform_to_points,
    auto_orient_and_center_poses,
)
from gaussiangrasper_torch.utils.image_io import image_size


@dataclass
class TransformsJsonParser:
    data: Path
    transforms_name: str = "transforms.json"
    auto_orient: bool = False
    auto_scale_poses: bool = False
    scale_factor: float = 1.0

    def parse(self) -> DataparserOutputs:
        data = Path(self.data)
        tpath = data / self.transforms_name
        if not tpath.exists():
            # Blender-style split files
            for alt in ("transforms_train.json", "transforms_test.json"):
                if (data / alt).exists():
                    tpath = data / alt
                    break
        meta = json.loads(tpath.read_text())

        frames = meta["frames"]
        poses = np.array([f["transform_matrix"] for f in frames], np.float64)[:, :3]

        if self.auto_orient:
            poses, transform = auto_orient_and_center_poses(poses)
        else:
            transform = np.eye(4)[:3]
        scale = self.scale_factor
        if self.auto_scale_poses:
            scale /= float(np.max(np.abs(poses[:, :3, 3]))) or 1.0
        poses = poses.copy()
        poses[:, :3, 3] *= scale

        names, parsed = [], []
        for f, pose in zip(frames, poses):
            name = f["file_path"]
            if not Path(name).suffix:
                name = name + ".png"
            names.append(name)
            # resolution: frame-level > global > probe image
            w = f.get("w", meta.get("w"))
            h = f.get("h", meta.get("h"))
            if w is None:
                w, h = image_size(data / name)
            if "fl_x" in f or "fl_x" in meta:
                fx = f.get("fl_x", meta.get("fl_x"))
                fy = f.get("fl_y", meta.get("fl_y", fx))
            else:
                fx = fy = 0.5 * w / np.tan(0.5 * meta["camera_angle_x"])
            cx = f.get("cx", meta.get("cx", w / 2.0))
            cy = f.get("cy", meta.get("cy", h / 2.0))
            dist = np.zeros(6)
            for i, k in enumerate(("k1", "k2", "p1", "p2", "k3", "k4")):
                dist[i] = f.get(k, meta.get(k, 0.0))
            parsed.append(
                ParsedCamera(
                    fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
                    width=int(w), height=int(h),
                    camera_to_world=pose.astype(np.float32),
                    distortion=dist,
                )
            )

        metadata = {}
        # dnerf-style per-frame times (nerfstudio's DNeRFDataParser
        # reads frame["time"], data/dataparsers/dnerf_dataparser.py)
        if any("time" in f for f in frames):
            n = max(len(frames) - 1, 1)
            metadata["times"] = np.array(
                [float(f.get("time", i / n)) for i, f in enumerate(frames)],
                np.float32,
            )
        ply = meta.get("ply_file_path")
        if ply and (data / ply).exists():
            xyz, rgb = _read_ply_points(data / ply)
            xyz = apply_transform_to_points(transform, xyz) * scale
            metadata["points3D_xyz"] = xyz.astype(np.float32)
            metadata["points3D_rgb"] = rgb
        else:
            # scripts/generate_data.py writes a COLMAP text model next to
            # transforms.json in the SAME world frame — use it for seeding
            # (nerfstudio seeds from points3D whenever present).
            from gaussiangrasper_torch.data import colmap_io as cio

            for sub in ("sparse/0", "colmap/sparse/0"):
                for name, reader in (
                    ("points3D.bin", cio.read_points3d_binary),
                    ("points3D.txt", cio.read_points3d_text),
                ):
                    path = data / sub / name
                    if path.exists():
                        xyz, rgb, _ = reader(path)
                        xyz = apply_transform_to_points(transform, xyz) * scale
                        metadata["points3D_xyz"] = xyz.astype(np.float32)
                        metadata["points3D_rgb"] = rgb
                        break
                if "points3D_xyz" in metadata:
                    break

        return DataparserOutputs(
            image_filenames=[data / n for n in names],
            cameras=parsed,
            dataparser_scale=scale,
            dataparser_transform=transform.astype(np.float32),
            metadata=metadata,
        )


def _read_ply_points(path: Path):
    """Minimal ascii/binary-LE PLY reader for xyz(+rgb) vertex clouds."""
    with open(path, "rb") as fh:
        header = []
        while True:
            line = fh.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n = int(next(l.split()[-1] for l in header if l.startswith("element vertex")))
        props = [l.split() for l in header if l.startswith("property")]
        names = [p[2] for p in props]
        np_types = {"float": "f4", "double": "f8", "uchar": "u1", "uint8": "u1",
                    "int": "i4", "short": "i2", "ushort": "u2"}
        if fmt == "ascii":
            body = np.loadtxt(fh, max_rows=n)
            rec = {nm: body[:, i] for i, nm in enumerate(names)}
        else:
            dtype = np.dtype([(nm, np_types[p[1]]) for p, nm in zip(props, names)])
            body = np.frombuffer(fh.read(n * dtype.itemsize), dtype=dtype)
            rec = {nm: body[nm] for nm in names}
    xyz = np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float64)
    if "red" in rec:
        rgb = np.stack([rec["red"], rec["green"], rec["blue"]], -1).astype(np.uint8)
    else:
        rgb = np.full((n, 3), 127, np.uint8)
    return xyz, rgb
