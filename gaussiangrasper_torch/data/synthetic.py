"""Synthetic ray-traced tabletop dataset generator (real-image fixture; a
copy of the JAX package's data/synthetic.py that writes its PNGs with the
port's stdlib writer, byte for byte the same pixels).

It ray traces an image-like scene a Gaussian field cannot trivially
represent (hard sphere silhouettes, a checkerboard plane, Lambertian
shading) and writes the full GaussianGrasper directory convention that
`scripts/generate_data.py` produces from real RGB-D scans:

    images/r_###.png            rendered RGB views
    depths/r_###.npy            (H, W) metric z-depth
    normals/r_###.npy           (H, W, 3) world-frame surface normals
    masks/r_###.npy             (H, W) int32 instance ids (-1 = sky)
    boundary_mask/r_###.npy     (H, W) 0/1 hit mask
    features/r_###.npy          (Hf, Wf, 512) per-pixel "CLIP" embeddings
                                (fixed random unit vector per instance —
                                the EFD distillation target; stored
                                downscaled like real feature maps)
    transforms.json             OpenGL c2w poses + intrinsics
    sparse/0/points3D.txt       COLMAP-text surface points for seeding

`move_object(...)` produces the scene-update variant (one sphere rigidly
moved) for the scene-update flow. All numpy, no external renderer.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from gaussiangrasper_torch.utils.image_io import write_png

LIGHT_DIR = np.array([0.3, 0.5, 0.8])
AMBIENT = 0.35

# instance id -> (center, radius, albedo). Table plane is id 0.
SPHERES = {
    1: (np.array([0.35, 0.1, 0.3]), 0.30, np.array([0.85, 0.2, 0.2])),
    2: (np.array([-0.4, -0.15, 0.22]), 0.22, np.array([0.2, 0.4, 0.9])),
    3: (np.array([0.0, 0.45, 0.18]), 0.18, np.array([0.95, 0.8, 0.15])),
}
TABLE_ALBEDOS = (np.array([0.9, 0.9, 0.85]), np.array([0.25, 0.2, 0.18]))
TABLE_HALF = 1.2  # table extends [-H, H]^2 in xy at z=0


def _look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, 0.0, 1.0)):
    """OpenGL c2w (camera looks along -z, y up)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = eye
    return c2w


def _trace(origins, dirs, spheres) -> Dict[str, np.ndarray]:
    """Ray trace plane+spheres. origins (3,), dirs (..., 3) unit.
    Returns dict of hit t, instance id, world point, normal, albedo."""
    sh = dirs.shape[:-1]
    t_best = np.full(sh, np.inf)
    obj = np.full(sh, -1, np.int32)
    normal = np.zeros(sh + (3,))
    albedo = np.zeros(sh + (3,))

    # table plane z=0 (only from above)
    dz = dirs[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_pl = -origins[2] / dz
    px = origins[0] + t_pl * dirs[..., 0]
    py = origins[1] + t_pl * dirs[..., 1]
    ok = (t_pl > 1e-6) & (np.abs(px) < TABLE_HALF) & (np.abs(py) < TABLE_HALF)
    hit = ok & (t_pl < t_best)
    t_best = np.where(hit, t_pl, t_best)
    obj = np.where(hit, 0, obj)
    normal[hit] = (0.0, 0.0, 1.0)
    check = ((np.floor(px / 0.3) + np.floor(py / 0.3)) % 2).astype(int)
    albedo[hit] = np.where(check[hit, None] == 0, TABLE_ALBEDOS[0],
                           TABLE_ALBEDOS[1])

    for oid, (c, r, alb) in spheres.items():
        oc = origins - c
        b = np.einsum("...i,i->...", dirs, oc)
        disc = b * b - (oc @ oc - r * r)
        ok = disc > 0
        t_sp = np.where(ok, -b - np.sqrt(np.maximum(disc, 0.0)), np.inf)
        hit = ok & (t_sp > 1e-6) & (t_sp < t_best)
        t_best = np.where(hit, t_sp, t_best)
        obj = np.where(hit, oid, obj)
        pt = origins + np.where(np.isfinite(t_sp), t_sp, 0.0)[..., None] * dirs
        n = (pt - c) / r
        normal[hit] = n[hit]
        albedo[hit] = alb

    point = origins + np.where(np.isfinite(t_best), t_best, 0.0)[..., None] * dirs
    return {"t": t_best, "obj": obj, "point": point, "normal": normal,
            "albedo": albedo}


def _shade(tr) -> np.ndarray:
    l = LIGHT_DIR / np.linalg.norm(LIGHT_DIR)
    lam = np.clip(np.einsum("...i,i->...", tr["normal"], l), 0.0, 1.0)
    rgb = tr["albedo"] * (AMBIENT + (1 - AMBIENT) * lam)[..., None]
    rgb[tr["obj"] < 0] = 0.05  # dark sky
    return np.clip(rgb, 0.0, 1.0)


def clip_vectors(clip_dim: int = 512, seed: int = 7) -> Dict[int, np.ndarray]:
    """Fixed random unit 'CLIP' embedding per instance id (the synthetic
    distillation target; id -1 gets zeros)."""
    rng = np.random.default_rng(seed)
    out = {}
    for oid in [0] + sorted(SPHERES):
        v = rng.normal(size=clip_dim)
        out[oid] = (v / np.linalg.norm(v)).astype(np.float32)
    return out


def render_view(c2w: np.ndarray, width: int, height: int, fx: float,
                spheres=None) -> Dict[str, np.ndarray]:
    """Ray trace one view. Returns rgb/depth(z)/normal(world)/ids."""
    spheres = SPHERES if spheres is None else spheres
    j, i = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    # OpenGL pixel rays: x right, y up, -z forward; pixel centers at ints
    x = (i - width / 2) / fx
    y = -(j - height / 2) / fx
    d_cam = np.stack([x, y, -np.ones_like(x)], axis=-1)
    d_world = d_cam @ c2w[:3, :3].T
    d_world = d_world / np.linalg.norm(d_world, axis=-1, keepdims=True)
    tr = _trace(c2w[:3, 3], d_world, spheres)
    rgb = _shade(tr)
    # z-depth: distance along the camera forward axis (-z column)
    fwd = -c2w[:3, 2]
    depth = np.where(np.isfinite(tr["t"]),
                     np.einsum("...i,i->...", tr["point"] - c2w[:3, 3], fwd),
                     0.0)
    return {"rgb": rgb.astype(np.float32), "depth": depth.astype(np.float32),
            "normal": tr["normal"].astype(np.float32), "ids": tr["obj"],
            "point": tr["point"].astype(np.float32)}


def generate_tabletop(
    out_dir: Path,
    width: int = 96,
    height: int = 96,
    n_views: int = 8,
    clip_dim: int = 512,
    feature_downscale: int = 4,
    seed_points: int = 2000,
    spheres=None,
    seed: int = 0,
    view_phase: float = 0.0,
    view_height=1.4,
) -> Path:
    """Write the full dataset; returns out_dir.

    view_phase/view_height offset the camera orbit — a second capture of
    the SAME scene at an interleaved phase gives held-out eval views in
    the same (identity) world frame, a train/eval split for full-scale
    convergence runs. view_height may be a sequence (cycled per view) for
    a multi-elevation capture — a single-ring capture overfits angularly
    and generalizes poorly off-ring."""
    out_dir = Path(out_dir)
    spheres = SPHERES if spheres is None else spheres
    for sub in ("images", "depths", "normals", "masks", "boundary_mask",
                "features"):
        (out_dir / sub).mkdir(parents=True, exist_ok=True)
    (out_dir / "sparse" / "0").mkdir(parents=True, exist_ok=True)

    fx = 1.1 * width
    clips = clip_vectors(clip_dim)
    frames = []
    cloud_pts, cloud_rgb = [], []
    rng = np.random.default_rng(seed)
    fd = feature_downscale

    heights = (view_height if isinstance(view_height, (tuple, list))
               else [view_height])
    for v in range(n_views):
        ang = 2 * np.pi * v / n_views + view_phase
        eye = np.array([2.0 * np.cos(ang), 2.0 * np.sin(ang),
                        heights[v % len(heights)]])
        c2w = _look_at(eye, np.array([0.0, 0.0, 0.2]))
        view = render_view(c2w, width, height, fx, spheres)
        stem = f"r_{v:03d}"
        write_png(out_dir / "images" / f"{stem}.png", (view["rgb"] * 255).astype(np.uint8))
        np.save(out_dir / "depths" / f"{stem}.npy", view["depth"])
        np.save(out_dir / "normals" / f"{stem}.npy", view["normal"])
        np.save(out_dir / "masks" / f"{stem}.npy", view["ids"])
        np.save(out_dir / "boundary_mask" / f"{stem}.npy",
                (view["ids"] >= 0).astype(np.uint8))
        feat = np.zeros((height // fd, width // fd, clip_dim), np.float32)
        ids_ds = view["ids"][fd // 2 :: fd, fd // 2 :: fd][
            : height // fd, : width // fd]
        for oid, vec in clips.items():
            feat[ids_ds == oid] = vec
        np.save(out_dir / "features" / f"{stem}.npy",
                feat.astype(np.float16))
        frames.append({"file_path": f"images/{stem}.png",
                       "transform_matrix": c2w.tolist()})

        # surface points for seeding (subsampled hits)
        hit = view["ids"] >= 0
        pts = view["point"][hit]
        cols = view["rgb"][hit]
        take = rng.choice(len(pts), size=min(len(pts), seed_points // n_views),
                          replace=False)
        cloud_pts.append(pts[take])
        cloud_rgb.append(cols[take])

    (out_dir / "transforms.json").write_text(json.dumps({
        "fl_x": fx, "fl_y": fx, "cx": width / 2, "cy": height / 2,
        "w": width, "h": height, "frames": frames,
    }))

    pts = np.concatenate(cloud_pts)
    cols = (np.concatenate(cloud_rgb) * 255).astype(np.uint8)
    with open(out_dir / "sparse" / "0" / "points3D.txt", "w") as fh:
        fh.write("# 3D point list: POINT3D_ID X Y Z R G B ERROR TRACK[]\n")
        for k, (p, c) in enumerate(zip(pts, cols)):
            fh.write(f"{k + 1} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                     f"{c[0]} {c[1]} {c[2]} 0.5\n")
    return out_dir


def move_object(
    out_dir: Path,
    oid: int = 1,
    delta: Tuple[float, float, float] = (-0.55, 0.45, 0.0),
    **kw,
) -> Tuple[Path, np.ndarray]:
    """Scene-update variant: sphere `oid` rigidly translated by `delta`.
    Writes a sibling dataset (the `after_updating` data dir) and returns (dir, the moved object's surface
    points BEFORE the move) — the edit_object point cloud update.py's
    convex-hull selection consumes."""
    out_dir = Path(out_dir)
    moved = {k: ((c + np.asarray(delta), r, a) if k == oid else (c, r, a))
             for k, (c, r, a) in SPHERES.items()}
    after = generate_tabletop(out_dir, spheres=moved, **kw)

    # surface samples of the ORIGINAL object (what project_hull/update use)
    c, r, _ = SPHERES[oid]
    rng = np.random.default_rng(3)
    d = rng.normal(size=(512, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return after, (c + r * d).astype(np.float32)
