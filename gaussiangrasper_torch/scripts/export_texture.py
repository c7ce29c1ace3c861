"""Export a textured mesh (.obj + .mtl + .png) from a trainer run
(counterpart of the JAX package's scripts/export_texture.py).

Renders up to --max-views views on the device (`models.model.render`, K1
on the card), fuses their depths into a TSDF, surfaces it with marching
tetrahedra, gives every face its own texel-aligned chart on a square grid
(the reference's per-triangle unwrap), and bakes each texel's colour from
the most front-facing view whose rendered depth agrees with it. Everything
after the renders is host-side numpy; the PNG is written by the port's
stdlib writer.

    python -m gaussiangrasper_torch.scripts.export_texture --run RUN \\
        --output OUT_DIR [--resolution 128] [--cell-px 16] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Tuple

import numpy as np

from gaussiangrasper_torch._device import resolve_device
from gaussiangrasper_torch.scripts.export_pointcloud import (
    TSDFVolume, camera_numpy, render_views, unproject_view)
from gaussiangrasper_torch.utils.image_io import write_png


def unwrap_per_triangle(faces: np.ndarray, cell_px: int = 16) -> Tuple[np.ndarray, int, int]:
    """Each face its own right-triangle chart in a square grid. Returns
    (uvs (F, 3, 2) in [0, 1], grid side in cells, texture side in px)."""
    f = len(faces)
    grid = int(np.ceil(np.sqrt(f)))
    tex = grid * cell_px
    cell = np.arange(f)
    cx = (cell % grid) * cell_px
    cy = (cell // grid) * cell_px
    pad = 0.5  # a half-texel inset keeps bilinear samples inside the chart
    corners = np.stack([
        np.stack([cx + pad, cy + pad], -1),
        np.stack([cx + cell_px - 1 - pad, cy + pad], -1),
        np.stack([cx + pad, cy + cell_px - 1 - pad], -1),
    ], axis=1).astype(np.float64)  # (F, 3, 2) in pixels
    return corners / tex, grid, tex


def face_texels(verts: np.ndarray, faces: np.ndarray, grid: int,
                cell_px: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """3D positions and texture pixel coords of every texel of every face
    chart: (positions (F, S, 3), tex_xy (F, S, 2) int, inside (F, S) bool),
    S = cell_px^2."""
    f = len(faces)
    lin = np.arange(cell_px * cell_px)
    lx = (lin % cell_px).astype(np.float64)
    ly = (lin // cell_px).astype(np.float64)
    # the chart's UV corners sit at texel centres 0 and cell_px - 2 (the
    # half-texel inset on both sides), so b = 1 lands on texel cell_px - 2
    b1 = lx / (cell_px - 2)
    b2 = ly / (cell_px - 2)
    inside = b1 + b2 <= 1.0 + 1e-9
    b0 = 1.0 - b1 - b2

    tri = verts[faces]  # (F, 3, 3)
    pos = (b0[None, :, None] * tri[:, 0:1, :] + b1[None, :, None] * tri[:, 1:2, :]
           + b2[None, :, None] * tri[:, 2:3, :])  # (F, S, 3)

    cell = np.arange(f)
    cx = (cell % grid) * cell_px
    cy = (cell // grid) * cell_px
    tex_xy = np.stack([cx[:, None] + lx[None, :], cy[:, None] + ly[None, :]], -1).astype(np.int64)
    return pos, tex_xy, np.broadcast_to(inside, (f, len(lin)))


def bake_from_views(positions: np.ndarray, normals: np.ndarray, view_images: List[np.ndarray],
                    view_depths: List[np.ndarray], cameras, depth_eps: float = 0.05) -> np.ndarray:
    """Per point, the bilinear colour of the most front-facing view whose
    rendered depth agrees with the point (visibility)."""
    m = len(positions)
    best_score = np.full(m, -np.inf)
    out = np.full((m, 3), 0.5, np.float64)
    for img, dep, cam in zip(view_images, view_depths, cameras):
        fx, fy, cx, cy, cam_c2w = camera_numpy(cam)
        c2w = cam_c2w.astype(np.float64)
        r, t = c2w[:3, :3], c2w[:3, 3]
        p_cam = (positions - t) @ r  # world -> camera (OpenGL)
        z = -p_cam[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            x = fx * p_cam[:, 0] / np.maximum(z, 1e-9) + cx
            y = -fy * p_cam[:, 1] / np.maximum(z, 1e-9) + cy
        h, w = dep.shape
        xi = np.clip(x, 0, w - 1)
        yi = np.clip(y, 0, h - 1)
        in_img = (z > 1e-6) & (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
        d_r = dep[yi.astype(int), xi.astype(int)]
        visible = in_img & (np.abs(d_r - z) < depth_eps * np.maximum(z, 1.0))
        view_dir = positions - t
        view_dir /= np.maximum(np.linalg.norm(view_dir, axis=1, keepdims=True), 1e-9)
        score = -np.sum(view_dir * normals, axis=1)  # front-facing > 0
        score = np.where(visible, score, -np.inf)
        take = score > best_score
        if take.any():
            x0 = np.floor(xi).astype(int)
            y0 = np.floor(yi).astype(int)
            x1 = np.minimum(x0 + 1, w - 1)
            y1 = np.minimum(y0 + 1, h - 1)
            wx = (xi - x0)[:, None]
            wy = (yi - y0)[:, None]
            c = (img[y0, x0] * (1 - wx) * (1 - wy) + img[y0, x1] * wx * (1 - wy)
                 + img[y1, x0] * (1 - wx) * wy + img[y1, x1] * wx * wy)
            out[take] = c[take]
            best_score[take] = score[take]
    return np.clip(out, 0.0, 1.0)


def face_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    tri = verts[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)


def write_obj(out_dir: Path, name: str, verts: np.ndarray, faces: np.ndarray, uvs: np.ndarray,
              texture: np.ndarray) -> Path:
    """Write <name>.obj + <name>.mtl + <name>.png."""
    out_dir.mkdir(parents=True, exist_ok=True)
    write_png(out_dir / f"{name}.png", (texture * 255).astype(np.uint8))
    (out_dir / f"{name}.mtl").write_text(f"newmtl {name}\nKd 1.0 1.0 1.0\nmap_Kd {name}.png\n")
    lines = [f"mtllib {name}.mtl", f"usemtl {name}"]
    for v in verts:
        lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
    for fuv in uvs:  # (3, 2) a face; OBJ's v origin is bottom-left
        for uv in fuv:
            lines.append(f"vt {uv[0]:.6f} {1.0 - uv[1]:.6f}")
    for i, f in enumerate(faces):
        t = 3 * i
        lines.append(f"f {f[0] + 1}/{t + 1} {f[1] + 1}/{t + 2} {f[2] + 1}/{t + 3}")
    path = out_dir / f"{name}.obj"
    path.write_text("\n".join(lines) + "\n")
    return path


def bake_mesh_texture(verts: np.ndarray, faces: np.ndarray, view_images, view_depths, cameras,
                      cell_px: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """Unwrap and bake: (uvs (F, 3, 2), texture (S, S, 3) in [0, 1])."""
    uvs, grid, tex = unwrap_per_triangle(faces, cell_px)
    pos, tex_xy, inside = face_texels(verts, faces, grid, cell_px)
    normals = face_normals(verts, faces)
    colors = bake_from_views(pos.reshape(-1, 3), np.repeat(normals, pos.shape[1], axis=0),
                             view_images, view_depths, cameras)
    texture = np.full((tex, tex, 3), 0.5)
    xy = tex_xy.reshape(-1, 2)
    keep = inside.reshape(-1)
    texture[xy[keep, 1], xy[keep, 0]] = colors[keep]
    return uvs, texture


def main(argv=None) -> Path:
    """Bake and write; returns the .obj path."""
    p = argparse.ArgumentParser(description="Bake a textured mesh from a trained run")
    p.add_argument("--run", type=Path, required=True)
    p.add_argument("--output", type=Path, required=True)
    p.add_argument("--name", type=str, default="mesh")
    p.add_argument("--resolution", type=int, default=128, help="TSDF voxel resolution")
    p.add_argument("--cell-px", type=int, default=16, help="texels per face chart edge")
    p.add_argument("--max-views", type=int, default=16)
    p.add_argument("--max-depth", type=float, default=6.0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    views = render_views(
        args.run, lambda n: np.linspace(0, n - 1, min(args.max_views, n), dtype=int),
        resolve_device(args.device))
    images = [rgb for rgb, _, _ in views]
    depths = [depth for _, depth, _ in views]
    cams = [cam for _, _, cam in views]

    # scene bounds from the rendered geometry
    pts = np.concatenate([unproject_view(dep, img, cam, args.max_depth)[0]
                          for img, dep, cam in views])
    lo, hi = pts.min(0) - 0.05, pts.max(0) + 0.05
    vol = TSDFVolume(np.stack([lo, hi]), resolution=args.resolution)
    for dep, cam in zip(depths, cams):
        vol.integrate(dep, cam)
    verts, faces = vol.extract_mesh()
    print(f"mesh: {len(verts)} verts, {len(faces)} faces")

    uvs, texture = bake_mesh_texture(verts, faces, images, depths, cams, cell_px=args.cell_px)
    path = write_obj(args.output, args.name, verts, faces, uvs, texture)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
