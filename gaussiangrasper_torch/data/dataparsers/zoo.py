"""Named dataparsers and layout auto-detection (a port of the JAX
package's data/dataparsers/zoo.py: the fifteen named parsers and
`resolve_parser`).

Each parser reads a public dataset layout into the shared
`DataparserOutputs` contract (base.py), in host-side numpy; frame sizes
come from the files' headers (`utils/image_io.image_size`).
`phototourism-raw` is a stub that raises SystemExit, as in the JAX package.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from gaussiangrasper_torch.data.dataparsers.base import (
    DataparserOutputs,
    ParsedCamera,
    auto_orient_and_center_poses,
)
from gaussiangrasper_torch.data.dataparsers.colmap import ColmapDataParser
from gaussiangrasper_torch.data.dataparsers.transforms_json import TransformsJsonParser
from gaussiangrasper_torch.utils.image_io import image_size


def _rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Axis-angle -> rotation matrix (cv2.Rodrigues, host-side numpy)."""
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + math.sin(theta) * kx + (1 - math.cos(theta)) * kx @ kx


def _split_indices(n: int, split: str, train_fraction: float = 0.9):
    """Equally-spaced train split, remainder eval (nerfstudio's
    train_split_fraction convention, e.g. arkitscenes_dataparser.py:128)."""
    n_train = math.ceil(n * train_fraction)
    i_train = np.linspace(0, n - 1, n_train, dtype=int)
    if split == "train":
        return i_train
    return np.setdiff1d(np.arange(n), i_train)


@dataclass
class BlenderParser:
    """NeRF-synthetic (Blender) scenes (nerfstudio's blender_dataparser.py:65-107):
    transforms_{split}.json, camera_angle_x focal, file_path + '.png',
    white alpha background."""

    data: Path
    split: str = "train"
    scale_factor: float = 1.0
    alpha_color: str = "white"

    def parse(self) -> DataparserOutputs:
        data = Path(self.data)
        meta = json.loads((data / f"transforms_{self.split}.json").read_text())
        names, parsed = [], []
        w = h = None
        for f in meta["frames"]:
            name = f["file_path"].replace("./", "")
            if not Path(name).suffix:
                name += ".png"
            names.append(name)
            if w is None:
                w, h = image_size(data / name)
            focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
            pose = np.array(f["transform_matrix"], np.float32)[:3]
            pose[:, 3] *= self.scale_factor
            parsed.append(
                ParsedCamera(
                    fx=focal, fy=focal, cx=w / 2.0, cy=h / 2.0,
                    width=int(w), height=int(h), camera_to_world=pose,
                )
            )
        return DataparserOutputs(
            image_filenames=[data / n for n in names],
            cameras=parsed,
            dataparser_scale=self.scale_factor,
            dataparser_transform=np.eye(4, dtype=np.float32)[:3],
            metadata={"alpha_color": self.alpha_color},
        )


@dataclass
class InstantNGPParser:
    """instant-ngp-format transforms.json (nerfstudio's instant_ngp_dataparser.py:
    65-196): fl from fl_x / x_fov / camera_angle_x, k1..p2 distortion,
    poses scaled by scene_scale (default 1/3), aabb_scale metadata."""

    data: Path
    split: str = "train"
    scene_scale: float = 0.3333

    def parse(self) -> DataparserOutputs:
        data = Path(self.data)
        tpath = data / "transforms.json"
        if not tpath.exists():
            tpath = data / f"transforms_{self.split}.json"
        meta = json.loads(tpath.read_text())

        w = int(meta.get("w", 0))
        h = int(meta.get("h", 0))
        fl_x, fl_y = self._focals(meta, w)
        names, parsed = [], []
        for f in meta["frames"]:
            name = f["file_path"]
            if not Path(name).suffix:
                name += ".png"
            pose = np.array(f["transform_matrix"], np.float64)[:3]
            pose[:, 3] *= self.scene_scale
            fw = int(f.get("w", w)) or w
            fh = int(f.get("h", h)) or h
            dist = np.zeros(6)
            dist[0] = float(meta.get("k1", 0))
            dist[1] = float(meta.get("k2", 0))
            dist[2] = float(meta.get("p1", 0))
            dist[3] = float(meta.get("p2", 0))
            names.append(name)
            parsed.append(
                ParsedCamera(
                    fx=float(f.get("fl_x", fl_x)), fy=float(f.get("fl_y", fl_y)),
                    cx=float(meta.get("cx", fw / 2)), cy=float(meta.get("cy", fh / 2)),
                    width=fw, height=fh,
                    camera_to_world=pose.astype(np.float32),
                    distortion=dist,
                )
            )
        aabb = 0.5 * float(meta.get("aabb_scale", 1))
        return DataparserOutputs(
            image_filenames=[data / n for n in names],
            cameras=parsed,
            dataparser_scale=self.scene_scale,
            dataparser_transform=np.eye(4, dtype=np.float32)[:3],
            metadata={"aabb": [[-aabb] * 3, [aabb] * 3]},
        )

    @staticmethod
    def _focals(meta, w):
        """fl_x/fl_y fallback chain (nerfstudio's instant_ngp_dataparser.py:209-231)."""
        def fov_to_fl(fov_rad, dim):
            return dim / (2.0 * np.tan(fov_rad / 2.0))

        if "fl_x" in meta:
            fl_x = meta["fl_x"]
        elif "x_fov" in meta:
            fl_x = fov_to_fl(np.deg2rad(meta["x_fov"]), meta["w"])
        elif "camera_angle_x" in meta:
            fl_x = fov_to_fl(meta["camera_angle_x"], meta["w"])
        else:
            raise ValueError("no focal length in transforms.json")
        if "fl_y" in meta:
            fl_y = meta["fl_y"]
        elif "y_fov" in meta:
            fl_y = fov_to_fl(np.deg2rad(meta["y_fov"]), meta["h"])
        elif "camera_angle_y" in meta:
            fl_y = fov_to_fl(meta["camera_angle_y"], meta["h"])
        else:
            fl_y = fl_x
        return float(fl_x), float(fl_y)


@dataclass
class MinimalParser:
    """Pre-prepared {split}.npz bundles (nerfstudio's minimal_dataparser.py:50-100):
    image_filenames, cameras dict (fx/fy/cx/cy/camera_to_worlds/height/
    width), scene_box aabb, optional mask_filenames."""

    data: Path
    split: str = "train"

    def parse(self) -> DataparserOutputs:
        data = Path(self.data)
        filepath = data / f"{self.split}.npz"
        blob = np.load(filepath, allow_pickle=True)
        names = [str(p) for p in blob["image_filenames"].tolist()]
        cam = blob["cameras"].item()
        n = len(names)

        def per(key, i):
            v = np.asarray(cam[key])
            return v[i] if v.ndim > 0 and len(v) == n else v

        parsed = []
        for i in range(n):
            c2w = np.asarray(per("camera_to_worlds", i), np.float32)
            if c2w.shape == (4, 4):
                c2w = c2w[:3]
            parsed.append(
                ParsedCamera(
                    fx=float(per("fx", i)), fy=float(per("fy", i)),
                    cx=float(per("cx", i)), cy=float(per("cy", i)),
                    width=int(per("width", i)), height=int(per("height", i)),
                    camera_to_world=c2w,
                )
            )
        mask_filenames = None
        if "mask_filenames" in blob:
            mask_filenames = [filepath.parent / p
                              for p in blob["mask_filenames"].tolist()]
        return DataparserOutputs(
            image_filenames=[filepath.parent / p for p in names],
            cameras=parsed,
            dataparser_scale=1.0,
            dataparser_transform=np.eye(4, dtype=np.float32)[:3],
            metadata={"aabb": np.asarray(blob["scene_box"]).tolist()},
            mask_filenames=mask_filenames,
        )


@dataclass
class ScannetParser:
    """ScanNet densely-extracted scenes (nerfstudio's scannet_dataparser.py:75-140):
    color/*.jpg + depth/*.png (mm) + pose/*.txt + intrinsic/
    intrinsic_color.txt; OpenCV->OpenGL y/z flip; skips non-finite poses;
    auto-centers and auto-scales."""

    data: Path
    split: str = "train"
    train_fraction: float = 0.9
    auto_scale: bool = True
    depth_unit_scale: float = 1e-3

    def parse(self) -> DataparserOutputs:
        data = Path(self.data)
        img_dir = data / "color"
        pose_dir = data / "pose"
        depth_dir = data / "depth"
        by_stem = lambda p: int(p.stem)
        imgs = sorted(img_dir.iterdir(), key=by_stem)
        poses_f = sorted(pose_dir.iterdir(), key=by_stem)
        depths = (
            sorted(depth_dir.iterdir(), key=by_stem)
            if depth_dir.exists() else [None] * len(imgs)
        )
        K = np.loadtxt(data / "intrinsic" / "intrinsic_color.txt")

        names, poses, dfiles = [], [], []
        for img, pf, df in zip(imgs, poses_f, depths):
            pose = np.loadtxt(pf).reshape(4, 4)
            if not np.isfinite(pose).all():
                continue
            pose[:3, 1] *= -1  # OpenCV -> OpenGL
            pose[:3, 2] *= -1
            names.append(img)
            poses.append(pose[:3])
            dfiles.append(df)

        poses = np.stack(poses)
        poses, transform = auto_orient_and_center_poses(poses, method="none")
        scale = 1.0
        if self.auto_scale:
            scale /= float(np.max(np.abs(poses[:, :3, 3]))) or 1.0
        poses[:, :3, 3] *= scale

        idx = _split_indices(len(names), self.split, self.train_fraction)
        w, h = image_size(names[0])
        parsed = [
            ParsedCamera(
                fx=float(K[0, 0]), fy=float(K[1, 1]),
                cx=float(K[0, 2]), cy=float(K[1, 2]),
                width=w, height=h,
                camera_to_world=poses[i].astype(np.float32),
            )
            for i in idx
        ]
        return DataparserOutputs(
            image_filenames=[names[i] for i in idx],
            cameras=parsed,
            dataparser_scale=scale,
            dataparser_transform=transform.astype(np.float32),
            metadata={
                "depth_filenames": [dfiles[i] for i in idx],
                "depth_unit_scale_factor": self.depth_unit_scale * scale,
            },
        )


@dataclass
class SdfstudioParser:
    """sdfstudio-format meta_data.json (nerfstudio's sdfstudio_dataparser.py:67-131):
    per-frame 4x4 intrinsics + camtoworld, OpenCV->OpenGL conversion,
    scene_box from metadata."""

    data: Path
    split: str = "train"

    def parse(self) -> DataparserOutputs:
        data = Path(self.data)
        meta = json.loads((data / "meta_data.json").read_text())
        h, w = int(meta["height"]), int(meta["width"])
        names, parsed = [], []
        for frame in meta["frames"]:
            intr = np.array(frame["intrinsics"], np.float64)
            c2w = np.array(frame["camtoworld"], np.float64)
            c2w[0:3, 1:3] *= -1  # OpenCV -> OpenGL
            names.append(frame["rgb_path"])
            parsed.append(
                ParsedCamera(
                    fx=float(intr[0, 0]), fy=float(intr[1, 1]),
                    cx=float(intr[0, 2]), cy=float(intr[1, 2]),
                    width=w, height=h,
                    camera_to_world=c2w[:3].astype(np.float32),
                )
            )
        meta_out = {}
        if "scene_box" in meta and "aabb" in meta["scene_box"]:
            meta_out["aabb"] = meta["scene_box"]["aabb"]
        return DataparserOutputs(
            image_filenames=[data / n for n in names],
            cameras=parsed,
            dataparser_scale=1.0,
            dataparser_transform=np.eye(4, dtype=np.float32)[:3],
            metadata=meta_out,
        )


@dataclass
class ARKitScenesParser:
    """ARKitScenes 3dod captures (nerfstudio's arkitscenes_dataparser.py:36-200):
    {video}_frames/lowres_wide + lowres_wide.traj (timestamp + axis-angle
    + translation, world-to-cam, inverted) + per-frame .pincam intrinsics;
    OpenCV->OpenGL flip; equally-spaced train split; auto-center+scale."""

    data: Path
    split: str = "train"
    train_fraction: float = 0.9
    auto_scale: bool = True

    def parse(self) -> DataparserOutputs:
        data = Path(self.data)
        video_id = data.name
        base = data / f"{video_id}_frames"
        img_dir = base / "lowres_wide"
        intr_dir = base / "lowres_wide_intrinsics"
        traj_file = base / "lowres_wide.traj"

        poses_from_traj = {}
        for line in traj_file.read_text().splitlines():
            tok = line.split()
            if len(tok) != 7:
                continue
            ts = f"{round(float(tok[0]), 3):.3f}"
            r = _rodrigues(np.array([float(t) for t in tok[1:4]]))
            ext = np.eye(4)
            ext[:3, :3] = r
            ext[:3, 3] = [float(t) for t in tok[4:7]]
            poses_from_traj[ts] = np.linalg.inv(ext)  # w2c -> c2w

        names, poses, intrinsics = [], [], []
        for img in sorted(img_dir.iterdir()):
            frame_id = img.stem.split("_", 1)[1]
            ts = f"{round(float(frame_id), 3):.3f}"
            if ts not in poses_from_traj:
                continue
            pincam = intr_dir / f"{video_id}_{frame_id}.pincam"
            if not pincam.exists():
                continue
            w, h, fx, fy, cx, cy = np.loadtxt(pincam)
            pose = poses_from_traj[ts].copy()
            pose[:3, 1] *= -1  # OpenCV -> OpenGL
            pose[:3, 2] *= -1
            names.append(img)
            poses.append(pose[:3])
            intrinsics.append((fx, fy, cx, cy, int(w), int(h)))

        poses = np.stack(poses)
        poses, transform = auto_orient_and_center_poses(poses, method="none")
        scale = 1.0
        if self.auto_scale:
            scale /= float(np.max(np.abs(poses[:, :3, 3]))) or 1.0
        poses[:, :3, 3] *= scale
        idx = _split_indices(len(names), self.split, self.train_fraction)
        parsed = [
            ParsedCamera(
                fx=float(intrinsics[i][0]), fy=float(intrinsics[i][1]),
                cx=float(intrinsics[i][2]), cy=float(intrinsics[i][3]),
                width=intrinsics[i][4], height=intrinsics[i][5],
                camera_to_world=poses[i].astype(np.float32),
            )
            for i in idx
        ]
        return DataparserOutputs(
            image_filenames=[names[i] for i in idx],
            cameras=parsed,
            dataparser_scale=scale,
            dataparser_transform=transform.astype(np.float32),
        )


@dataclass
class DycheckParser:
    """DyCheck iphone-subset bundles (nerfstudio's dycheck_dataparser.py:199-341):
    scene.json (center/scale/near/far), splits/{split}.json (frame_names +
    time_ids), per-frame camera/{frame}.json (row-major `orientation`
    transposed to c2w, position centered by scene center and scaled),
    images at rgb/{d}x/, depths at depth/{d}x/. nerfstudio's OpenCV->
    OpenGL + world-axis shuffles (nerfstudio :297-302) are reproduced exactly;
    times are normalized by the dataset's max warp id (nerfstudio :312)."""

    data: Path
    split: str = "train"
    downscale_factor: int = 1
    scene_box_bound: float = 1.5

    def parse(self) -> DataparserOutputs:
        data = Path(self.data)
        scene = json.loads((data / "scene.json").read_text())
        center = np.asarray(scene["center"], np.float32)
        scene_scale = float(scene["scale"])
        far = float(scene["far"])
        metadata_all = json.loads((data / "metadata.json").read_text())
        max_time = max(
            (int(v["warp_id"]) for v in metadata_all.values()), default=1
        ) or 1

        split_file = data / "splits" / f"{self.split}.json"
        if not split_file.exists():
            split_file = data / "splits" / "train.json"
        split_dict = json.loads(split_file.read_text())
        frame_names = list(split_dict["frame_names"])
        time_ids = list(split_dict["time_ids"])

        # scale the scene to fill the aabb (nerfstudio :229-231)
        sf = self.scene_box_bound / 4.0 / (scene_scale * far)
        d = self.downscale_factor

        names, depths, parsed, times = [], [], [], []
        for frame, t in zip(frame_names, time_ids):
            cam = json.loads((data / "camera" / f"{frame}.json").read_text())
            c2w = np.asarray(cam["orientation"], np.float64).T
            position = np.asarray(cam["position"], np.float64) - center
            position *= scene_scale * sf
            pose = np.zeros((3, 4))
            pose[:3, :3] = c2w
            pose[:3, 3] = position
            pose[0:3, 1:3] *= -1      # OpenCV -> OpenGL cam axes
            pose = pose[[1, 0, 2], :]  # switch world x,y
            pose[2, :] *= -1           # invert world z
            pose = pose[[1, 2, 0], :]  # world xyz -> zxy (aabb usage)
            fl = float(cam["focal_length"])
            names.append(data / f"rgb/{d}x/{frame}.png")
            depths.append(data / f"depth/{d}x/{frame}.npy")
            times.append(float(t) / max_time)
            parsed.append(
                ParsedCamera(
                    fx=fl / d,
                    fy=fl * float(cam.get("pixel_aspect_ratio", 1.0)) / d,
                    cx=float(cam["principal_point"][0]) / d,
                    cy=float(cam["principal_point"][1]) / d,
                    width=int(cam["image_size"][0]) // d,
                    height=int(cam["image_size"][1]) // d,
                    camera_to_world=pose.astype(np.float32),
                )
            )
        scale = scene_scale * sf
        return DataparserOutputs(
            image_filenames=names,
            cameras=parsed,
            dataparser_scale=scale,
            dataparser_transform=np.eye(4, dtype=np.float32)[:3],
            metadata={
                "depth_filenames": depths,
                "depth_unit_scale_factor": scale,
                "times": times,
                "near": float(scene["near"]) * scale,
                "far": far * scale,
                "aabb": [[-self.scene_box_bound] * 3,
                         [self.scene_box_bound] * 3],
            },
        )


@dataclass
class Sitcoms3DParser:
    """sitcoms3D bundles (nerfstudio's sitcoms3d_dataparser.py:64-153): cameras.json
    with per-frame 3x3 intrinsics + 4x4 camtoworld and a scene bbox; world
    rotated 90 deg about x (z-up), box centered, longest bbox edge scaled
    to scene_scale; images under images{_d}/; optional thing-segmentation
    filenames."""

    data: Path
    split: str = "train"
    downscale_factor: int = 4
    scene_scale: float = 2.0
    include_semantics: bool = False

    def parse(self) -> DataparserOutputs:
        data = Path(self.data)
        meta = json.loads((data / "cameras.json").read_text())
        frames = meta["frames"]
        bbox = np.asarray(meta["bbox"], np.float64)

        suffix = f"_{self.downscale_factor}" if self.downscale_factor != 1 else ""
        images_folder = f"images{suffix}"

        rotation = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float64)
        bbox = (rotation @ bbox.T).T
        center = (bbox[0] + bbox[1]) / 2.0
        lengths = bbox[1] - bbox[0]
        scale = self.scene_scale / float(np.max(lengths))
        aabb = (bbox - center) * scale

        names, parsed = [], []
        d = float(self.downscale_factor)
        for frame in frames:
            intr = np.asarray(frame["intrinsics"], np.float64)
            c2w = np.asarray(frame["camtoworld"], np.float64)[:3]
            c2w[:3, :3] = rotation @ c2w[:3, :3]
            c2w[:3, 3] = rotation @ c2w[:3, 3]
            c2w[:, 3] = (c2w[:, 3] - center) * scale
            names.append(data / images_folder / frame["image_name"])
            parsed.append(
                ParsedCamera(
                    fx=float(intr[0, 0]) / d, fy=float(intr[1, 1]) / d,
                    cx=float(intr[0, 2]) / d, cy=float(intr[1, 2]) / d,
                    width=int(round(frame["width"] / d)) if "width" in frame
                    else int(round(2.0 * intr[0, 2] / d)),
                    height=int(round(frame["height"] / d)) if "height" in frame
                    else int(round(2.0 * intr[1, 2] / d)),
                    camera_to_world=c2w.astype(np.float32),
                )
            )
        meta_out = {"aabb": aabb.tolist()}
        if self.include_semantics:
            meta_out["semantic_filenames"] = [
                data / f"segmentations{suffix}" / "thing"
                / Path(frame["image_name"]).with_suffix(".png").name
                for frame in frames
            ]
        return DataparserOutputs(
            image_filenames=names,
            cameras=parsed,
            dataparser_scale=scale,
            dataparser_transform=np.concatenate(
                [rotation, (rotation @ -center[:, None])], axis=1
            ).astype(np.float32) * np.float32(scale),
            metadata=meta_out,
        )


@dataclass
class NerfosrParser:
    """NeRF-OSR sessions (nerfstudio's nerfosr_dataparser.py:155-232): per-split
    intrinsics/*.txt + pose/*.txt (whitespace 4x4 matrices, OpenCV c2w
    converted to OpenGL), rgb/ images, optional mask/; ALL splits are
    oriented/centered/scaled together (focus centering + auto scale) so
    train/val/test share one world frame, then sliced by split."""

    data: Path
    split: str = "train"
    scene: str = ""
    """Scene subdirectory; empty = `data` already points at the scene's
    final/ directory."""
    scale_factor: float = 1.0
    use_masks: bool = False

    @staticmethod
    def _read_mat(path: Path) -> np.ndarray:
        return np.array(
            [float(x) for x in path.read_text().split()], np.float64
        ).reshape(4, 4)

    @classmethod
    def _split_params(cls, scene_dir: Path, split: str):
        intr_files = sorted((scene_dir / split / "intrinsics").glob("*.txt"))
        pose_files = sorted((scene_dir / split / "pose").glob("*.txt"))
        intr, poses = [], []
        for i_f, p_f in zip(intr_files, pose_files):
            intr.append(cls._read_mat(i_f))
            pose = cls._read_mat(p_f)
            pose[0:3, 1:3] *= -1  # OpenCV -> OpenGL
            poses.append(pose[:3])
        return intr, poses

    @staticmethod
    def _images(scene_dir: Path, split: str, sub: str):
        out = []
        for ext in ("*.png", "*.jpg", "*.JPG", "*.PNG"):
            out.extend((scene_dir / split / sub).glob(ext))
        return sorted(out)

    def parse(self) -> DataparserOutputs:
        data = Path(self.data)
        if self.scene:
            sub = "final_clean" if self.scene == "trevi" else "final"
            scene_dir = data / self.scene / sub
        else:
            scene_dir = data
        split = "validation" if self.split == "val" else self.split

        per_split = {s: self._split_params(scene_dir, s)
                     for s in ("train", "validation", "test")}
        counts = {s: len(per_split[s][1]) for s in per_split}
        all_poses = np.stack(
            [p for s in ("train", "validation", "test") for p in per_split[s][1]]
        )
        all_poses, transform = auto_orient_and_center_poses(
            all_poses, method="up", center_method="focus"
        )
        scale = 1.0 / (float(np.max(np.abs(all_poses[:, :3, 3]))) or 1.0)
        all_poses[:, :3, 3] *= scale * self.scale_factor

        start = {"train": 0,
                 "validation": counts["train"],
                 "test": counts["train"] + counts["validation"]}[split]
        n = counts[split]
        intr = per_split[split][0]
        names = self._images(scene_dir, split, "rgb")

        parsed = []
        w = h = None
        for i in range(n):
            if w is None and names:
                w, h = image_size(names[0])
            parsed.append(
                ParsedCamera(
                    fx=float(intr[i][0, 0]), fy=float(intr[i][1, 1]),
                    cx=float(intr[i][0, 2]), cy=float(intr[i][1, 2]),
                    width=int(w or round(2 * intr[i][0, 2])),
                    height=int(h or round(2 * intr[i][1, 2])),
                    camera_to_world=all_poses[start + i].astype(np.float32),
                )
            )
        masks = self._images(scene_dir, split, "mask") if self.use_masks else None
        return DataparserOutputs(
            image_filenames=names,
            cameras=parsed,
            dataparser_scale=scale * self.scale_factor,
            dataparser_transform=transform.astype(np.float32),
            mask_filenames=masks or None,
        )


@dataclass
class NuScenesParser:
    """nuScenes scenes WITHOUT the devkit (nerfstudio's nuscenes_dataparser.py:88-
    216): the devkit's `nusc.get(table, token)` is a lookup into plain
    JSON arrays under `<dataroot>/<version>/*.json`, so this reads
    scene/sample/sample_data/calibrated_sensor/ego_pose directly. Pose
    math replicates nerfstudio's exactly: c2w = ego_pose @ cam_pose
    (scalar-first quaternions), rotated into the OpenCV frame
    (transform1, nerfstudio :109-115), OpenCV -> nerfstudio axis flips
    (nerfstudio :144-147), then z-up (transform2, nerfstudio :117-122); poses centered
    on the mean translation and scaled by the max |t| (nerfstudio :163-167);
    0.9 train split by equally-spaced snapshot indices (nerfstudio :170-186)."""

    data: Path                      # dataroot (contains v1.0-*/ + samples/)
    split: str = "train"
    scene: Optional[str] = None     # scene name; None = first scene
    version: Optional[str] = None   # auto-detects v1.0-mini / v1.0-trainval
    cameras: tuple = ("FRONT",)
    train_split_fraction: float = 0.9
    mask_dir: Optional[Path] = None
    """Directory holding per-camera masks (nerfstudio's nuscenes_dataparser.py:
    131-135 + scripts/datasets/process_nuscenes_masks.py): mask files live
    at <mask_dir>/masks/<CAM_NAME>/<image stem>.png. None = no masks."""

    def _tables(self, version: str):
        root = Path(self.data) / version
        out = {}
        for name in ("scene", "sample", "sample_data", "calibrated_sensor",
                     "ego_pose"):
            rows = json.loads((root / f"{name}.json").read_text())
            out[name] = {r["token"]: r for r in rows}
        return out

    @staticmethod
    def _pose(rot_wxyz, trans) -> np.ndarray:
        w, x, y, z = rot_wxyz
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])
        pose = np.eye(4)
        pose[:3, :3] = r
        pose[:3, 3] = trans
        return pose

    def parse(self) -> DataparserOutputs:
        data = Path(self.data)
        version = self.version
        if version is None:
            for v in ("v1.0-mini", "v1.0-trainval", "v1.0-test"):
                if (data / v).exists():
                    version = v
                    break
            else:
                raise FileNotFoundError(f"no v1.0-* table dir under {data}")
        t = self._tables(version)

        scenes = list(t["scene"].values())
        if self.scene is not None:
            scenes = [s for s in scenes if s["name"] == str(self.scene)]
            if not scenes:
                raise KeyError(f"scene {self.scene!r} not in {version}")
        scene_tokens = {s["token"] for s in scenes[:1]}
        samples = [s for s in t["sample"].values()
                   if s["scene_token"] in scene_tokens]
        samples.sort(key=lambda s: (s["scene_token"], s["timestamp"]))

        transform1 = np.array([[0, -1, 0, 0], [0, 0, -1, 0],
                               [1, 0, 0, 0], [0, 0, 0, 1.0]])
        transform2 = np.array([[0, 0, 1, 0], [0, 1, 0, 0],
                               [-1, 0, 0, 0], [0, 0, 0, 1.0]])
        cams = ["CAM_" + c for c in self.cameras]
        names, mask_names, intr, poses, whs = [], [], [], [], []
        for sample in samples:
            for cam in cams:
                sd = t["sample_data"][sample["data"][cam]]
                cs = t["calibrated_sensor"][sd["calibrated_sensor_token"]]
                ego = t["ego_pose"][sd["ego_pose_token"]]
                pose = (self._pose(ego["rotation"], ego["translation"])
                        @ self._pose(cs["rotation"], cs["translation"]))
                pose = transform1 @ pose
                pose[0:3, 1:3] *= -1           # OpenCV cam -> OpenGL cam
                pose = pose[np.array([1, 0, 2, 3]), :]
                pose[2, :] *= -1
                pose = transform2 @ pose       # z-up
                names.append(data / sd["filename"])
                if self.mask_dir is not None:
                    # nerfstudio :131-135: <mask_dir>/masks/<CAM>/<img>.png (the
                    # masks are produced from the jpg captures, hence the
                    # jpg -> png rename)
                    img_name = Path(sd["filename"]).name.replace(
                        "jpg", "png")
                    mask_names.append(
                        Path(self.mask_dir) / "masks" / cam / img_name)
                intr.append(np.asarray(cs["camera_intrinsic"], np.float64))
                whs.append((int(sd.get("width", 1600)),
                            int(sd.get("height", 900))))
                poses.append(pose)
        poses = np.stack(poses).astype(np.float64)
        center = poses[:, :3, 3].mean(0)
        poses[:, :3, 3] -= center
        scale = 1.0 / max(np.abs(poses[:, :3, 3]).max(), 1e-8)
        poses[:, :3, 3] *= scale

        n_snap = len(samples)
        n_train = math.ceil(n_snap * self.train_split_fraction)
        i_train = np.linspace(0, n_snap - 1, n_train, dtype=int)
        i_eval = np.setdiff1d(np.arange(n_snap), i_train)
        if self.split == "train":
            snap = i_train
        elif self.split in ("val", "validation", "test"):
            snap = i_eval
        else:  # nerfstudio's nuscenes_dataparser.py:185 raises on unknown splits
            raise ValueError(f"Unknown dataparser split {self.split!r}")
        idx = (snap[None, :] * len(cams)
               + np.arange(len(cams))[:, None]).ravel()

        parsed = [
            ParsedCamera(
                fx=float(intr[i][0, 0]), fy=float(intr[i][1, 1]),
                cx=float(intr[i][0, 2]), cy=float(intr[i][1, 2]),
                width=whs[i][0], height=whs[i][1],
                camera_to_world=poses[i][:3].astype(np.float32),
            )
            for i in idx
        ]
        transform = np.concatenate(
            [np.eye(3), -center[:, None]], axis=1
        ).astype(np.float32)
        return DataparserOutputs(
            image_filenames=[names[i] for i in idx],
            cameras=parsed,
            dataparser_scale=float(scale),
            dataparser_transform=transform,
            mask_filenames=(
                [mask_names[i] for i in idx] if mask_names else None
            ),
        )


def _stub(name: str, needs: str):
    @dataclass
    class Stub:
        data: Path
        split: str = "train"

        def parse(self):
            raise SystemExit(
                f"dataparser {name!r} needs {needs}, which is unavailable "
                "in this zero-egress image. Convert the capture with "
                "scripts/generate_data.py or provide a transforms.json/"
                "COLMAP layout instead."
            )

    Stub.__name__ = f"{name.title()}Stub"
    return Stub


# name -> parser factory (data, **kwargs) — nerfstudio registers 15
# named dataparsers (dataparser_configs.py:40-55)
PARSERS: Dict[str, Callable] = {
    "colmap": ColmapDataParser,
    "nerfstudio": TransformsJsonParser,
    "blender": BlenderParser,
    "instant-ngp": InstantNGPParser,
    "minimal": MinimalParser,
    "scannet": ScannetParser,
    "sdfstudio": SdfstudioParser,
    "arkitscenes": ARKitScenesParser,
    # dnerf data is blender-with-time; transforms_json already lifts the
    # per-frame `time` field into metadata["times"]
    "dnerf": TransformsJsonParser,
    # nerfstudio's phototourism parser reads a COLMAP reconstruction
    # (phototourism_dataparser.py) — ours does too
    "phototourism": ColmapDataParser,
    "nuscenes": NuScenesParser,
    "dycheck": DycheckParser,
    "sitcoms3d": Sitcoms3DParser,
    "nerfosr": NerfosrParser,
    "phototourism-raw": _stub("phototourism-raw", "image downloads"),
}


def resolve_parser(data: Path, name: str = "auto"):
    """Instantiate a parser by name, or auto-detect it from the on-disk
    layout, markers checked in the JAX package's order."""
    data = Path(data)
    if name != "auto":
        if name not in PARSERS:
            raise KeyError(f"unknown dataparser {name!r}; have {sorted(PARSERS)}")
        return PARSERS[name](data)
    if (data / "meta_data.json").exists():
        return SdfstudioParser(data)
    if (data / "scene.json").exists() and (data / "splits").exists():
        return DycheckParser(data)
    if (data / "cameras.json").exists():
        return Sitcoms3DParser(data)
    if (data / "intrinsic" / "intrinsic_color.txt").exists():
        return ScannetParser(data)
    if (data / f"{data.name}_frames").exists():
        return ARKitScenesParser(data)
    if (data / "train.npz").exists():
        return MinimalParser(data)
    if any((data / v).exists() for v in ("v1.0-mini", "v1.0-trainval")):
        return NuScenesParser(data)
    if (data / "transforms.json").exists() or list(data.glob("transforms_*.json")):
        return TransformsJsonParser(data)
    return ColmapDataParser(data)
