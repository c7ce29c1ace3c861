"""The benchmark's inputs, made from the seed and the configuration.

Copies, so that later changes to the program cannot move the inputs:
- `generate_tabletop`: gaussiangrasper_torch/data/synthetic.py at commit
  d90391f (the ray-traced tabletop capture in the GaussianGrasper
  directory layout), writing its PNGs with `write_png` below and keeping
  each view's RGB bytes and the seed cloud as .npy under `bench_raw/`,
  which the program's parsers do not read, for the benchmark's own checks;
- `orbit_c2w`, `bench_field`, `seeded_fea_up_arrays`: chip_smoke.py at
  commit d90391f (the serve and train points), `bench_field` drawn on the
  device from a torch.Generator in a few large calls.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import struct
import zlib
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from .common import CACHE

LIGHT_DIR = np.array([0.3, 0.5, 0.8])
AMBIENT = 0.35
SPHERES = {
    1: (np.array([0.35, 0.1, 0.3]), 0.30, np.array([0.85, 0.2, 0.2])),
    2: (np.array([-0.4, -0.15, 0.22]), 0.22, np.array([0.2, 0.4, 0.9])),
    3: (np.array([0.0, 0.45, 0.18]), 0.18, np.array([0.95, 0.8, 0.15])),
}
TABLE_ALBEDOS = (np.array([0.9, 0.9, 0.85]), np.array([0.25, 0.2, 0.18]))
TABLE_HALF = 1.2


def write_png(path: Path, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG, every scanline with filter 0."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _look_at(eye, target, up=(0.0, 0.0, 1.0)):
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


def _trace(origins, dirs, spheres):
    sh = dirs.shape[:-1]
    t_best = np.full(sh, np.inf)
    obj = np.full(sh, -1, np.int32)
    normal = np.zeros(sh + (3,))
    albedo = np.zeros(sh + (3,))
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
    albedo[hit] = np.where(check[hit, None] == 0, TABLE_ALBEDOS[0], TABLE_ALBEDOS[1])
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
    return {"t": t_best, "obj": obj, "point": point, "normal": normal, "albedo": albedo}


def _shade(tr):
    light = LIGHT_DIR / np.linalg.norm(LIGHT_DIR)
    lam = np.clip(np.einsum("...i,i->...", tr["normal"], light), 0.0, 1.0)
    rgb = tr["albedo"] * (AMBIENT + (1 - AMBIENT) * lam)[..., None]
    rgb[tr["obj"] < 0] = 0.05
    return np.clip(rgb, 0.0, 1.0)


def clip_vectors(clip_dim: int = 512, seed: int = 7) -> Dict[int, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {}
    for oid in [0] + sorted(SPHERES):
        v = rng.normal(size=clip_dim)
        out[oid] = (v / np.linalg.norm(v)).astype(np.float32)
    return out


def render_view(c2w, width, height, fx, spheres):
    j, i = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    x = (i - width / 2) / fx
    y = -(j - height / 2) / fx
    d_cam = np.stack([x, y, -np.ones_like(x)], axis=-1)
    d_world = d_cam @ c2w[:3, :3].T
    d_world = d_world / np.linalg.norm(d_world, axis=-1, keepdims=True)
    tr = _trace(c2w[:3, 3], d_world, spheres)
    rgb = _shade(tr)
    fwd = -c2w[:3, 2]
    depth = np.where(np.isfinite(tr["t"]), np.einsum("...i,i->...", tr["point"] - c2w[:3, 3], fwd), 0.0)
    return {"rgb": rgb.astype(np.float32), "depth": depth.astype(np.float32),
            "normal": tr["normal"].astype(np.float32), "ids": tr["obj"],
            "point": tr["point"].astype(np.float32)}


def generate_tabletop(out_dir: Path, width: int, height: int, n_views: int, clip_dim: int = 512,
                      feature_downscale: int = 4, seed_points: int = 2000, seed: int = 0,
                      view_height: float = 1.4) -> Path:
    """The capture: images/, depths/, normals/, masks/, boundary_mask/,
    features/, transforms.json and sparse/0/points3D.txt, plus bench_raw/
    (each view's RGB bytes, the seed cloud)."""
    out_dir = Path(out_dir)
    for sub in ("images", "depths", "normals", "masks", "boundary_mask", "features", "bench_raw"):
        (out_dir / sub).mkdir(parents=True, exist_ok=True)
    (out_dir / "sparse" / "0").mkdir(parents=True, exist_ok=True)
    fx = 1.1 * width
    clips = clip_vectors(clip_dim)
    frames, cloud_pts, cloud_rgb = [], [], []
    rng = np.random.default_rng(seed)
    fd = feature_downscale
    for v in range(n_views):
        ang = 2 * np.pi * v / n_views
        eye = np.array([2.0 * np.cos(ang), 2.0 * np.sin(ang), view_height])
        c2w = _look_at(eye, np.array([0.0, 0.0, 0.2]))
        view = render_view(c2w, width, height, fx, SPHERES)
        stem = f"r_{v:03d}"
        rgb8 = (view["rgb"] * 255).astype(np.uint8)
        write_png(out_dir / "images" / f"{stem}.png", rgb8)
        np.save(out_dir / "bench_raw" / f"{stem}_rgb.npy", rgb8)
        np.save(out_dir / "depths" / f"{stem}.npy", view["depth"])
        np.save(out_dir / "normals" / f"{stem}.npy", view["normal"])
        np.save(out_dir / "masks" / f"{stem}.npy", view["ids"])
        np.save(out_dir / "boundary_mask" / f"{stem}.npy", (view["ids"] >= 0).astype(np.uint8))
        feat = np.zeros((height // fd, width // fd, clip_dim), np.float32)
        ids_ds = view["ids"][fd // 2::fd, fd // 2::fd][: height // fd, : width // fd]
        for oid, vec in clips.items():
            feat[ids_ds == oid] = vec
        np.save(out_dir / "features" / f"{stem}.npy", feat.astype(np.float16))
        frames.append({"file_path": f"images/{stem}.png", "transform_matrix": c2w.tolist()})
        hit = view["ids"] >= 0
        pts, cols = view["point"][hit], view["rgb"][hit]
        take = rng.choice(len(pts), size=min(len(pts), seed_points // n_views), replace=False)
        cloud_pts.append(pts[take])
        cloud_rgb.append(cols[take])
    (out_dir / "transforms.json").write_text(json.dumps({
        "fl_x": fx, "fl_y": fx, "cx": width / 2, "cy": height / 2,
        "w": width, "h": height, "frames": frames}))
    pts = np.concatenate(cloud_pts)
    cols = (np.concatenate(cloud_rgb) * 255).astype(np.uint8)
    np.save(out_dir / "bench_raw" / "points_xyz.npy", pts)
    np.save(out_dir / "bench_raw" / "points_rgb.npy", cols)
    lines = [f"{k + 1} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]} 0.5\n"
             for k, (p, c) in enumerate(zip(pts, cols))]
    (out_dir / "sparse" / "0" / "points3D.txt").write_text(
        "# 3D point list: POINT3D_ID X Y Z R G B ERROR TRACK[]\n" + "".join(lines))
    return out_dir


def tabletop(scene: dict) -> Path:
    """The configuration's capture, generated once into the checkout's
    cache at a path fixed by its sizes; later runs read it."""
    key = "tabletop-{width}x{height}-{n_views}v-{seed_points}p-s{layout_seed}".format(**scene)
    final = CACHE / "datasets" / key
    if (final / "DONE").exists():
        return final
    staging = CACHE / "datasets" / (key + ".partial")
    shutil.rmtree(staging, ignore_errors=True)
    shutil.rmtree(final, ignore_errors=True)
    generate_tabletop(staging, scene["width"], scene["height"], scene["n_views"],
                      feature_downscale=scene["feature_downscale"],
                      seed_points=scene["seed_points"], seed=scene["layout_seed"])
    (staging / "DONE").write_text("")
    os.replace(staging, final)
    return final


def capture_views(data: Path) -> Tuple[np.ndarray, dict]:
    """(c2w (V, 4, 4) float64 as transforms.json holds them, its intrinsics)."""
    meta = json.loads((Path(data) / "transforms.json").read_text())
    c2w = np.array([f["transform_matrix"] for f in meta["frames"]], np.float64)
    return c2w, meta


def orbit_c2w(angle: float, target=(0.0, 0.0, -3.0), radius: float = 3.0) -> np.ndarray:
    """OpenGL camera-to-world on a horizontal circle around `target`."""
    target = np.asarray(target)
    eye = target + radius * np.array([math.sin(angle), 0.0, math.cos(angle)])
    back = (eye - target) / np.linalg.norm(eye - target)
    right = np.cross([0.0, 1.0, 0.0], back)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(back, right), back, eye], 1).astype(np.float32)


def seeded_fea_up_arrays(seed: int, dims=(32, 128, 512)) -> dict:
    """fea_up weights {w{i} (d_in, d_out), b{i}} with torch.nn.Linear's
    default U(-1/sqrt(fan_in), +) draws."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        bound = 1.0 / math.sqrt(a)
        arrays[f"w{i}"] = rng.uniform(-bound, bound, (a, b)).astype(np.float32)
        arrays[f"b{i}"] = rng.uniform(-bound, bound, b).astype(np.float32)
    return arrays


def fea_up_state(arrays: dict, device) -> Dict[str, "object"]:
    """`FeaUp.state_dict()` layout (weights (d_out, d_in)) of those arrays."""
    import torch

    out = {}
    for i in range(len(arrays) // 2):
        out[f"layers.{i}.weight"] = torch.tensor(arrays[f"w{i}"].T.copy(), device=device)
        out[f"layers.{i}.bias"] = torch.tensor(arrays[f"b{i}"], device=device)
    return out


def bench_field(n: int, seed: int, device, feature_dim: int = 32) -> Dict[str, "object"]:
    """bench.py's scene as chip_smoke.py makes it: means uniform in a cube
    of side 4 scaled by (0.5, 0.5, 0.25) and shifted to z = -3, scale 0.02,
    random quats, opacity 0.1, a random base colour, SH rest bands
    0.1 N(0, 1) so all 25 coefficients do work, features U(-1, 1); drawn
    on `device` from one torch.Generator."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand((n, 9 + feature_dim), generator=g, device=device)
    rest = 0.1 * torch.randn((n, 24, 3), generator=g, device=device)
    means = (u[:, 0:3] - 0.5) * 4.0 * torch.tensor([0.5, 0.5, 0.25], device=device) \
        + torch.tensor([0.0, 0.0, -3.0], device=device)
    a, b, c = u[:, 3], u[:, 4], u[:, 5]
    quats = torch.stack([torch.sqrt(1 - a) * torch.sin(2 * math.pi * b),
                         torch.sqrt(1 - a) * torch.cos(2 * math.pi * b),
                         torch.sqrt(a) * torch.sin(2 * math.pi * c),
                         torch.sqrt(a) * torch.cos(2 * math.pi * c)], -1)
    sh0 = (u[:, 6:9] - 0.5) / 0.28209479177387814
    return {
        "means": means,
        "log_scales": torch.full((n, 3), math.log(0.02), device=device),
        "quats": quats,
        "opacity_logits": torch.full((n,), math.log(0.1 / 0.9), device=device),
        "sh_coeffs": torch.cat([sh0[:, None], rest], 1),
        "features": u[:, 9:] * 2.0 - 1.0,
    }
