"""RGB-D capture -> training dataset: a fused seed point cloud, per-view
normal maps and a COLMAP text model with transforms.json (counterpart of
the JAX package's scripts/generate_data.py).

Each frame's depth is unprojected, its normals taken from cross products
of central differences of the unprojected points (oriented towards the
camera), and its points moved to the world, kept inside the depth range
and the world z band, every `--subsample`-th one seeding the cloud: all
torch ops in float64 on the entry point's device (the card unless
--device cpu), as the JAX tool computes them in numpy. `--icp` aligns each
frame to the cloud so far with point-to-point ICP on the host
(scipy.spatial.cKDTree), as the JAX tool does.

Input layout (aligned by sorted file name):
  <capture>/color/*.png       RGB (or JPEG)
  <capture>/depth/*.npy|png   metric depth (npy: metres; png: millimetres)
  <capture>/poses/*.npy       (4, 4) camera-to-world, OpenCV convention
  <capture>/intrinsics.json   {"fx", "fy", "cx", "cy", "width", "height"}
Output: images/, depths/, normals/, sparse/0/{cameras,images,points3D}.txt
and transforms.json, as data/dataset.py reads them.

    python -m gaussiangrasper_torch.scripts.generate_data --capture CAP --output OUT [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from gaussiangrasper_torch._device import resolve_device
from gaussiangrasper_torch.data import colmap_io as cio
from gaussiangrasper_torch.utils.image_io import read_image, write_png

F64 = torch.float64


def unproject_depth(depth: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """(H, W) metric depth -> (H, W, 3) float64 camera-frame points
    (OpenCV frame: x right, y down, z forward)."""
    h, w = depth.shape
    d = depth.to(F64)
    xs = torch.arange(w, dtype=F64, device=depth.device)[None, :]
    ys = torch.arange(h, dtype=F64, device=depth.device)[:, None]
    return torch.stack([(xs - cx) / fx * d, (ys - cy) / fy * d, d], -1)


def normals_from_depth(points_cam: torch.Tensor, flip_towards_camera: bool = True) -> torch.Tensor:
    """n = normalize((P[y, x+1] - P[y, x-1]) x (P[y+1, x] - P[y-1, x])),
    zero on the border rows and columns, flipped to face the camera (which
    looks down +z); float32."""
    dx = torch.zeros_like(points_cam)
    dy = torch.zeros_like(points_cam)
    dx[:, 1:-1] = points_cam[:, 2:] - points_cam[:, :-2]
    dy[1:-1, :] = points_cam[2:, :] - points_cam[:-2, :]
    a, b = dx.unbind(-1), dy.unbind(-1)
    n = torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], -1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-8)
    if flip_towards_camera:
        n = torch.where(torch.sum(n * points_cam, -1, keepdim=True) > 0, -n, n)
    return n.to(torch.float32)


def z_band_filter(points_w: torch.Tensor, z_min: float, z_max: float) -> torch.Tensor:
    """Points inside a world z band (the table-top crop)."""
    return (points_w[:, 2] > z_min) & (points_w[:, 2] < z_max)


def opencv_c2w_to_opengl(c2w: np.ndarray) -> np.ndarray:
    out = c2w.copy()
    out[:3, 1:3] *= -1.0
    return out


def icp_refine(src: np.ndarray, dst: np.ndarray, iterations: int = 20,
               max_corr_dist: float = 0.05) -> np.ndarray:
    """Point-to-point ICP aligning src onto dst on the host; returns a 4x4
    transform."""
    from scipy.spatial import cKDTree

    t_total = np.eye(4)
    cur = src.copy()
    tree = cKDTree(dst)
    for _ in range(iterations):
        dist, idx = tree.query(cur, distance_upper_bound=max_corr_dist)
        ok = np.isfinite(dist)
        if ok.sum() < 10:
            break
        a = cur[ok]
        b = dst[idx[ok]]
        ca, cb = a.mean(0), b.mean(0)
        h = (a - ca).T @ (b - cb)
        u, _, vt = np.linalg.svd(h)
        d = np.sign(np.linalg.det(vt.T @ u.T))
        r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
        t = cb - r @ ca
        step = np.eye(4)
        step[:3, :3] = r
        step[:3, 3] = t
        cur = cur @ r.T + t
        t_total = step @ t_total
        if np.linalg.norm(t) < 1e-7 and np.allclose(r, np.eye(3), atol=1e-7):
            break
    return t_total


def load_depth(path: Path) -> np.ndarray:
    """Metric depth, float32: a .npy in metres or a 16-bit PNG in mm."""
    if path.suffix == ".npy":
        return np.load(path).astype(np.float32)
    return read_image(path).astype(np.float32) / 1000.0


def _rotmat_to_qvec(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (w, x, y, z), numerically stable branch select."""
    tr = np.trace(r)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([0.25 * s, (r[2, 1] - r[1, 2]) / s,
                         (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s])
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (r[k, j] - r[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (r[j, i] + r[i, j]) / s
    q[1 + k] = (r[k, i] + r[i, k]) / s
    return q


def _rigid(points: torch.Tensor, m: np.ndarray, translate: bool = True) -> torch.Tensor:
    """(N, 3) float64 points @ m[:3, :3].T (+ m[:3, 3])."""
    t = torch.as_tensor(m, dtype=F64, device=points.device)
    out = points @ t[:3, :3].T
    return out + t[:3, 3] if translate else out


def main(argv=None) -> dict:
    """Write the dataset; returns {"points", "frames", "icp": [4x4 a frame]}."""
    p = argparse.ArgumentParser(description="RGB-D capture -> training dataset")
    p.add_argument("--capture", type=Path, required=True)
    p.add_argument("--output", type=Path, required=True)
    p.add_argument("--subsample", type=int, default=8, help="keep every k-th point for seeding")
    p.add_argument("--z-min", type=float, default=-10.0)
    p.add_argument("--z-max", type=float, default=10.0)
    p.add_argument("--depth-max", type=float, default=3.0)
    p.add_argument("--icp", action="store_true",
                   help="refine each frame's pose against the accumulated cloud with "
                        "point-to-point ICP")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cap, out = args.capture, args.output
    intr = json.loads((cap / "intrinsics.json").read_text())
    fx, fy, cx, cy = intr["fx"], intr["fy"], intr["cx"], intr["cy"]
    w, h = intr["width"], intr["height"]
    for d in ("images", "depths", "normals"):
        (out / d).mkdir(parents=True, exist_ok=True)
    sparse = out / "sparse" / "0"
    sparse.mkdir(parents=True, exist_ok=True)

    color_files = sorted((cap / "color").iterdir())
    depth_files = sorted((cap / "depth").iterdir())
    pose_files = sorted((cap / "poses").iterdir())
    assert len(color_files) == len(depth_files) == len(pose_files)

    all_xyz, all_rgb, icps = [], [], []
    frames, images_colmap = [], {}
    for i, (cf, df, pf) in enumerate(zip(color_files, depth_files, pose_files)):
        rgb = read_image(cf)[..., :3]
        depth = load_depth(df)
        c2w_cv = np.load(pf)

        depth_t = torch.as_tensor(depth, device=device)
        pts_cam = unproject_depth(depth_t, fx, fy, cx, cy)
        normals_w = _rigid(normals_from_depth(pts_cam).reshape(-1, 3).to(F64), c2w_cv,
                           translate=False)
        valid = (depth_t > 0.05) & (depth_t < args.depth_max)
        pts_w = _rigid(pts_cam.reshape(-1, 3), c2w_cv)
        keep = valid.reshape(-1) & z_band_filter(pts_w, args.z_min, args.z_max)
        idx = torch.nonzero(keep)[:, 0][::args.subsample]

        if args.icp and all_xyz:
            t_icp = icp_refine(pts_w[idx].cpu().numpy(), np.concatenate(all_xyz))
            icps.append(t_icp)
            c2w_cv = t_icp @ c2w_cv
            pts_w = _rigid(pts_w, t_icp)
            normals_w = _rigid(normals_w, t_icp, translate=False)

        idx_host = idx.cpu().numpy()
        all_xyz.append(pts_w[idx].cpu().numpy())
        all_rgb.append(rgb.reshape(-1, 3)[idx_host])

        name = f"frame_{i:05d}.png"
        write_png(out / "images" / name, np.ascontiguousarray(rgb))
        np.save(out / "depths" / f"frame_{i:05d}.npy", depth)
        np.save(out / "normals" / f"frame_{i:05d}.npy", normals_w.reshape(h, w, 3).cpu().numpy())

        frames.append({"file_path": f"images/{name}",
                       "transform_matrix": opencv_c2w_to_opengl(c2w_cv).tolist()})
        # COLMAP stores world-to-camera in the OpenCV frame
        w2c = np.linalg.inv(c2w_cv)
        images_colmap[i + 1] = cio.ColmapImage(_rotmat_to_qvec(w2c[:3, :3]), w2c[:3, 3], 1, name)

    xyz = np.concatenate(all_xyz)
    rgbs = np.concatenate(all_rgb)
    print(f"fused cloud: {len(xyz)} seed points from {len(frames)} frames")
    cio.write_cameras_text(sparse / "cameras.txt",
                           {1: cio.ColmapCamera("PINHOLE", w, h, np.array([fx, fy, cx, cy]))})
    cio.write_images_text(sparse / "images.txt", images_colmap)
    cio.write_points3d_text(sparse / "points3D.txt", xyz, rgbs)
    meta = {"fl_x": fx, "fl_y": fy, "cx": cx, "cy": cy, "w": w, "h": h, "frames": frames}
    (out / "transforms.json").write_text(json.dumps(meta, indent=2))
    print(f"dataset written to {out}")
    return {"points": len(xyz), "frames": len(frames), "icp": icps}


if __name__ == "__main__":
    main()
