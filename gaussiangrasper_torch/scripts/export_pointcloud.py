"""Export a fused RGB point cloud, and with --mesh a TSDF mesh, from a
trainer run (counterpart of the JAX package's scripts/export_pointcloud.py).

Each of the first --num-views views is rendered on the device
(`models.model.render`, K1 on the card); its depth and rgb are unprojected
to world points and written as one .ply. With --mesh a TSDF volume is fused
from the rendered depths and surfaced with marching tetrahedra (numpy).

    python -m gaussiangrasper_torch.scripts.export_pointcloud --run-dir RUN \\
        [--mesh] [--device cpu]

The host-side functions keep the JAX tool's arithmetic: its camera values
are float32 device scalars, so the pixel rays of `unproject_view` and the
voxel projections of `TSDFVolume.integrate` are computed in float32 there,
and here.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from gaussiangrasper_torch._device import resolve_device
from gaussiangrasper_torch.core.cameras import Camera
from gaussiangrasper_torch.models.model import render
from gaussiangrasper_torch.scripts.common import load_run


def camera_numpy(cam: Camera) -> Tuple[np.float32, np.float32, np.float32, np.float32,
                                       np.ndarray]:
    """(fx, fy, cx, cy) as float32 scalars and the (3, 4) OpenGL c2w as a
    float32 array, from a camera on any device."""
    fx, fy, cx, cy = (np.float32(float(v)) for v in (cam.fx, cam.fy, cam.cx, cam.cy))
    return fx, fy, cx, cy, cam.camera_to_world.detach().cpu().numpy()


def write_ply_points(path: Path, xyz: np.ndarray, rgb: np.ndarray) -> None:
    n = len(xyz)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    rec["xyz"] = xyz.astype(np.float32)
    rec["rgb"] = rgb.astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(rec.tobytes())


def write_ply_mesh(path: Path, verts: np.ndarray, faces: np.ndarray) -> None:
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    with open(path, "wb") as fh:
        fh.write(header.encode("ascii"))
        fh.write(verts.astype("<f4").tobytes())
        fr = np.zeros(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        fr["n"] = 3
        fr["idx"] = faces
        fh.write(fr.tobytes())


def unproject_view(depth: np.ndarray, rgb: np.ndarray, cam: Camera, max_depth: float):
    """Depth map -> world points + colors (OpenGL camera)."""
    fx, fy, cx, cy, c2w = camera_numpy(cam)
    h, w = depth.shape
    ys, xs = np.mgrid[0:h, 0:w]
    z = depth
    x = ((xs + 0.5).astype(np.float32) - cx) / fx * z
    y = -((ys + 0.5).astype(np.float32) - cy) / fy * z
    pts_cam = np.stack([x, y, -z], -1).reshape(-1, 3)  # OpenGL: -z forward
    keep = (z.reshape(-1) > 0.05) & (z.reshape(-1) < max_depth)
    pts_w = pts_cam[keep] @ c2w[:3, :3].T + c2w[:3, 3]
    return pts_w, rgb.reshape(-1, 3)[keep]


class TSDFVolume:
    """Truncated signed distance fusion."""

    def __init__(self, bounds: np.ndarray, resolution: int = 128, trunc: float = 0.04):
        self.origin = bounds[0]
        self.size = bounds[1] - bounds[0]
        self.res = resolution
        self.trunc = trunc
        self.tsdf = np.ones((resolution,) * 3, np.float32)
        self.weight = np.zeros((resolution,) * 3, np.float32)
        g = (np.arange(resolution) + 0.5) / resolution
        zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
        self.points = self.origin + np.stack([xx, yy, zz], -1).reshape(-1, 3) * self.size

    def integrate(self, depth: np.ndarray, cam: Camera) -> None:
        fx, fy, cx, cy, cam_c2w = camera_numpy(cam)
        c2w = np.eye(4)
        c2w[:3] = cam_c2w
        w2c = np.linalg.inv(c2w)
        p = self.points @ w2c[:3, :3].T + w2c[:3, 3]
        z = -p[:, 2]  # OpenGL: depth along -z
        with np.errstate(divide="ignore", invalid="ignore"):
            u = ((p[:, 0] / z).astype(np.float32) * fx + cx).astype(np.int32)
            v = ((-p[:, 1] / z).astype(np.float32) * fy + cy).astype(np.int32)
        ok = (z > 0.05) & (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
        d = np.zeros(len(p), np.float32)
        d[ok] = depth[v[ok], u[ok]]
        sdf = d - z
        ok &= (d > 0.05) & (sdf > -self.trunc)
        tsdf_new = np.clip(sdf / self.trunc, -1.0, 1.0)
        flat_t = self.tsdf.reshape(-1)
        flat_w = self.weight.reshape(-1)
        w_new = flat_w[ok] + 1.0
        flat_t[ok] = (flat_t[ok] * flat_w[ok] + tsdf_new[ok]) / w_new
        flat_w[ok] = w_new

    def extract_mesh(self):
        """Marching tetrahedra on the TSDF zero level set."""
        return marching_tetrahedra(self.tsdf, mask=self.weight > 0, origin=self.origin,
                                   scale=self.size / self.res)


# six tetrahedra a cube cell (corner c at offset bits x = c & 1,
# y = (c >> 1) & 1, z = (c >> 2) & 1)
_TETS = np.array(
    [[0, 5, 1, 6], [0, 1, 3, 6], [0, 3, 2, 6], [0, 2, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]],
    np.int64,
)
_CORNER_OFF = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)])


def marching_tetrahedra(vol: np.ndarray, mask, origin, scale):
    """Zero iso-surface of `vol` as (verts (V, 3), faces (F, 3))."""
    r = vol.shape[0]
    base = np.stack(np.meshgrid(*[np.arange(r - 1)] * 3, indexing="ij"), -1)
    cells = base.reshape(-1, 3)  # (C, 3) in z, y, x grid order
    corner_idx = cells[:, None, :] + _CORNER_OFF[None, :, ::-1]  # (C, 8, 3)
    vals = vol[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]]
    valid = mask[corner_idx[..., 0], corner_idx[..., 1], corner_idx[..., 2]].all(1)
    cells, vals, corner_idx = cells[valid], vals[valid], corner_idx[valid]

    verts, faces = [], []
    corner_pos = origin + (corner_idx[..., ::-1] + 0.5) * scale  # world x, y, z

    for tet in _TETS:
        v = vals[:, tet]            # (C, 4)
        p = corner_pos[:, tet]      # (C, 4, 3)
        inside = v < 0
        count = inside.sum(1)
        for target, flip in ((1, False), (3, True)):
            sel = count == target
            if not sel.any():
                continue
            vv, pp, ii = v[sel], p[sel], inside[sel]
            if flip:
                ii = ~ii  # the one outside vertex
            one = np.argmax(ii, axis=1)
            others = np.array([[j for j in range(4) if j != o] for o in one])
            rows = np.arange(len(one))
            tri = []
            for c in range(3):
                a, b = one, others[rows, c]
                va, vb = vv[rows, a], vv[rows, b]
                t = va / (va - vb + 1e-12)
                tri.append(pp[rows, a] + t[:, None] * (pp[rows, b] - pp[rows, a]))
            base_idx = sum(len(x) for x in verts)
            n = len(one)
            verts.extend(tri)
            idx = np.arange(n)
            faces.append(np.stack([base_idx + idx, base_idx + n + idx, base_idx + 2 * n + idx],
                                  -1))
        # two in, two out: a quad (two triangles)
        sel = count == 2
        if sel.any():
            vv, pp, ii = v[sel], p[sel], inside[sel]
            n = len(vv)
            ins = np.argsort(~ii, axis=1)[:, :2]
            outs = np.argsort(ii, axis=1)[:, :2]
            rows = np.arange(n)

            def edge(a_idx, b_idx):
                va, vb = vv[rows, a_idx], vv[rows, b_idx]
                t = va / (va - vb + 1e-12)
                return pp[rows, a_idx] + t[:, None] * (pp[rows, b_idx] - pp[rows, a_idx])

            e00 = edge(ins[:, 0], outs[:, 0])
            e01 = edge(ins[:, 0], outs[:, 1])
            e10 = edge(ins[:, 1], outs[:, 0])
            e11 = edge(ins[:, 1], outs[:, 1])
            base_idx = sum(len(x) for x in verts)
            verts.extend([e00, e01, e11, e10])
            idx = np.arange(n)
            faces.append(np.stack([base_idx + idx, base_idx + n + idx, base_idx + 2 * n + idx],
                                  -1))
            faces.append(np.stack([base_idx + idx, base_idx + 2 * n + idx,
                                   base_idx + 3 * n + idx], -1))

    if not verts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    return np.concatenate(verts).astype(np.float32), np.concatenate(faces)


def render_views(run_dir: Path, view_ids, device):
    """Render the run's dataset views `view_ids` (a callable of the view
    count) on `device`: [(rgb (H, W, 3) in [0, 1], depth (H, W), camera)]."""
    config, trainer, state = load_run(run_dir, device=device)
    dm = trainer.dm
    out = []
    with torch.no_grad():
        for i in view_ids(len(dm)):
            cam = dm.camera(int(i))
            outs = render(state.field, state.alive, cam, state.step, config.model)
            out.append((np.clip(outs["rgb"].cpu().numpy(), 0, 1),
                        outs["depth"][..., 0].cpu().numpy(), cam))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Export fused point cloud / TSDF mesh")
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--num-views", type=int, default=16)
    p.add_argument("--max-depth", type=float, default=8.0)
    p.add_argument("--max-points", type=int, default=1_000_000)
    p.add_argument("--mesh", action="store_true")
    p.add_argument("--tsdf-resolution", type=int, default=96)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    views = render_views(args.run_dir, lambda n: range(min(args.num_views, n)),
                         resolve_device(args.device))
    all_xyz, all_rgb = [], []
    for rgb, depth, cam in views:
        xyz, col = unproject_view(depth, rgb * 255, cam, args.max_depth)
        all_xyz.append(xyz)
        all_rgb.append(col)
    xyz = np.concatenate(all_xyz)
    rgb = np.concatenate(all_rgb)
    if len(xyz) > args.max_points:
        sel = np.random.default_rng(0).choice(len(xyz), args.max_points, False)
        xyz, rgb = xyz[sel], rgb[sel]
    out = args.output or (args.run_dir / "pointcloud.ply")
    write_ply_points(out, xyz, rgb)
    print(f"wrote {len(xyz)} points to {out}")

    if args.mesh:
        lo = np.percentile(xyz, 2, axis=0) - 0.05
        hi = np.percentile(xyz, 98, axis=0) + 0.05
        vol = TSDFVolume(np.stack([lo, hi]), resolution=args.tsdf_resolution)
        for _, depth, cam in views:
            vol.integrate(depth, cam)
        verts, faces = vol.extract_mesh()
        mesh_out = out.with_name(out.stem + "_mesh.ply")
        write_ply_mesh(mesh_out, verts, faces)
        print(f"wrote mesh ({len(verts)} verts, {len(faces)} faces) to {mesh_out}")


if __name__ == "__main__":
    main()
