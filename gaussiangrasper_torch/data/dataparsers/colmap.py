"""COLMAP sparse-reconstruction dataparser with 3D-point seeding (a copy
of the JAX package's data/dataparsers/colmap.py).

nerfstudio's ColmapDataParser (data/dataparsers/colmap_dataparser.py
:221-395): read cameras/images/points3D
(binary or text), convert COLMAP's OpenCV-convention world-to-camera poses
to OpenGL camera-to-world, auto-orient/center/scale, and stash the sparse
points as Gaussian seeds in metadata["points3D_xyz"/"points3D_rgb"].
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from gaussiangrasper_torch.data import colmap_io as cio
from gaussiangrasper_torch.data.dataparsers.base import (
    DataparserOutputs,
    ParsedCamera,
    apply_transform_to_points,
    auto_orient_and_center_poses,
)


@dataclass
class ColmapDataParser:
    data: Path
    images_path: str = "images"
    colmap_path: str = "colmap/sparse/0"
    load_3d_points: bool = True
    auto_scale_poses: bool = True
    scale_factor: float = 1.0
    orientation_method: str = "up"
    center_method: str = "poses"
    downscale_factor: int = 1

    def parse(self) -> DataparserOutputs:
        data = Path(self.data)
        colmap_dir = data / self.colmap_path
        if not colmap_dir.exists():
            # common alternative layout
            for alt in ("sparse/0", "sparse"):
                if (data / alt).exists():
                    colmap_dir = data / alt
                    break

        if (colmap_dir / "cameras.bin").exists():
            cams = cio.read_cameras_binary(colmap_dir / "cameras.bin")
            images = cio.read_images_binary(colmap_dir / "images.bin")
        else:
            cams = cio.read_cameras_text(colmap_dir / "cameras.txt")
            images = cio.read_images_text(colmap_dir / "images.txt")

        # COLMAP w2c (OpenCV frame) -> OpenGL c2w.
        names, poses, pcams = [], [], []
        for _, im in sorted(images.items(), key=lambda kv: kv[1].name):
            r = cio.qvec_to_rotmat(im.qvec)
            t = im.tvec
            c2w = np.eye(4)
            c2w[:3, :3] = r.T
            c2w[:3, 3] = -r.T @ t
            # OpenCV (y down, z forward) -> OpenGL (y up, z backward)
            c2w[:3, 1:3] *= -1.0
            poses.append(c2w[:3])
            names.append(im.name)
            pcams.append(cams[im.camera_id])
        poses = np.stack(poses)

        poses, transform = auto_orient_and_center_poses(
            poses, self.orientation_method, self.center_method
        )
        scale = self.scale_factor
        if self.auto_scale_poses:
            scale /= float(np.max(np.abs(poses[:, :3, 3]))) or 1.0
        poses = poses.copy()
        poses[:, :3, 3] *= scale

        parsed = []
        for pose, cam in zip(poses, pcams):
            fx, fy, cx, cy = cam.intrinsics()
            d = self.downscale_factor
            parsed.append(
                ParsedCamera(
                    fx=fx / d, fy=fy / d, cx=cx / d, cy=cy / d,
                    width=cam.width // d, height=cam.height // d,
                    camera_to_world=pose[:3].astype(np.float32),
                    distortion=cam.distortion(),
                    camera_type="fisheye" if "FISHEYE" in cam.model else "perspective",
                )
            )

        metadata = {}
        if self.load_3d_points:
            pts = self._load_points(colmap_dir)
            if pts is not None:
                xyz, rgb = pts
                xyz = apply_transform_to_points(transform, xyz) * scale
                metadata["points3D_xyz"] = xyz.astype(np.float32)
                metadata["points3D_rgb"] = rgb

        return DataparserOutputs(
            image_filenames=[data / self.images_path / n for n in names],
            cameras=parsed,
            dataparser_scale=scale,
            dataparser_transform=transform.astype(np.float32),
            metadata=metadata,
        )

    def _load_points(self, colmap_dir: Path):
        if (colmap_dir / "points3D.bin").exists():
            xyz, rgb, _ = cio.read_points3d_binary(colmap_dir / "points3D.bin")
        elif (colmap_dir / "points3D.txt").exists():
            xyz, rgb, _ = cio.read_points3d_text(colmap_dir / "points3D.txt")
        else:
            return None
        return xyz, rgb
