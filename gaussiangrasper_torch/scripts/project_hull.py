"""Per-view edit-region masks for the scene-update fine-tune (counterpart
of the JAX package's scripts/project_hull.py).

For each view of a capture, the edited object's 3D points, before and
after the move, are projected into the image; the convex hull of the
rounded pixel coordinates is filled, dilated by a d x d box, and saved as
<output>/<image stem>.npy (bool (H, W)).

The JAX tool draws with OpenCV (`convexHull`, `fillConvexPoly`, `dilate`),
which the card machine does not have. This module computes the same
pixels without it: a monotone-chain hull on the same int32 points (strict
turns only, as OpenCV keeps no collinear vertex), OpenCV's scanline fill in
16.16 fixed point with its 8-connected edge lines (so the border pixels
the fill sets are the same), and a box dilation anchored at d // 2 through
`max_pool2d`. Nothing is sized by the points' extent: a point just in front
of the camera projects millions of pixels away, and the scan only visits
the image's rows.

    python -m gaussiangrasper_torch.scripts.project_hull --data SCENE \\
        --edit-object obj.npy --transform-npy move.npy [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gaussiangrasper_torch._device import resolve_device

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
# the JAX tool casts the rounded coordinates to int32, undefined beyond
# its range; the port clips to it
COORD_LIMIT = float(2**31 - 1)


def project_points(pts_w: np.ndarray, w2c: np.ndarray, fx, fy, cx, cy) -> np.ndarray:
    """World points -> pixel coords via an OpenCV-convention w2c; points
    behind the camera are dropped."""
    p_cam = pts_w @ w2c[:3, :3].T + w2c[:3, 3]
    p = p_cam[p_cam[:, 2] > 1e-6]
    return np.stack([fx * p[:, 0] / p[:, 2] + cx, fy * p[:, 1] / p[:, 2] + cy], -1)


def convex_hull(pts: np.ndarray) -> List[Tuple[int, int]]:
    """Vertices of the convex hull of integer points (Andrew's monotone
    chain; collinear and repeated points dropped)."""
    p = sorted(set(map(tuple, pts.tolist())))
    if len(p) < 3:
        return p

    def half(seq):
        out: List[Tuple[int, int]] = []
        for q in seq:
            while len(out) >= 2 and ((out[-1][0] - out[-2][0]) * (q[1] - out[-2][1])
                                     - (out[-1][1] - out[-2][1]) * (q[0] - out[-2][0])) <= 0:
                out.pop()
            out.append(q)
        return out

    lower, upper = half(p), half(p[::-1])
    hull = lower[:-1] + upper[:-1]
    return hull if len(hull) >= 2 else lower


def _c_div(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(w: int, h: int, p1: List[int], p2: List[int]) -> bool:
    """OpenCV's clipLine on 64-bit points, in place; False if the segment
    misses the image."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    (x1, y1), (x2, y2) = p1, p2
    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    p1[:], p2[:] = [x1, y1], [x2, y2]
    return (c1 | c2) == 0


def _line(mask: np.ndarray, pt1, pt2) -> None:
    """OpenCV's 8-connected `line` (its LineIterator, left to right)."""
    h, w = mask.shape
    p1, p2 = [int(pt1[0]), int(pt1[1])], [int(pt2[0]), int(pt2[1])]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        if not _clip_line(w, h, p1, p2):
            return
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        p1, p2 = p2, p1
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = p1
    for _ in range(dx + 1):
        mask[y, x] = 1
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if steep:
            y += sy
            x += 1 if minor else 0
        else:
            x += 1
            y += sy if minor else 0


def fill_convex_poly(mask: np.ndarray, v: List[Tuple[int, int]]) -> None:
    """OpenCV's `fillConvexPoly(mask, v, 1)` (8-connected, shift 0): the
    edge lines, then the scanline fill between the two edge walkers in
    16.16 fixed point."""
    h, w = mask.shape
    n = len(v)
    if n == 0:
        return
    p0 = v[-1]
    for p in v:
        _line(mask, p0, p)
        p0 = p
    ys = [p[1] for p in v]
    xs = [p[0] for p in v]
    imin = int(np.argmin(ys))
    ymin, ymax, xmin, xmax = ys[imin], max(ys), min(xs), max(xs)
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    half = XY_ONE >> 1
    # per walker: [idx, di, x, dx, ye]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, n - 1, -XY_ONE, 0, ymin]]
    edges = n
    y = ymin
    while True:
        for e in edge:
            if y < e[4]:
                continue
            idx0, di = e[0], e[1]
            idx = (idx0 + di) % n
            while True:
                more = edges > 0
                edges -= 1
                if not more:
                    break
                ty = v[idx][1]
                if ty > y:
                    x_s, x_e = v[idx0][0] << XY_SHIFT, v[idx][0] << XY_SHIFT
                    e[4] = ty
                    e[3] = _c_div((x_e - x_s) * 2 + (ty - y), 2 * (ty - y))
                    e[2] = x_s
                    e[0] = idx
                    break
                idx0, idx = idx, (idx + di) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0][2] > edge[1][2] else (0, 1)
            x1 = (edge[left][2] + half) >> XY_SHIFT
            x2 = (edge[right][2] + half) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                mask[y, max(x1, 0): min(x2, w - 1) + 1] = 1
            step = 1
        else:  # rows above the image: skip to the next vertex row or row 0
            step = min(edge[0][4], edge[1][4], 0) - y
        edge[0][2] += edge[0][3] * step
        edge[1][2] += edge[1][3] * step
        y += step
        if y > ymax:
            break


def hull_mask(uv: np.ndarray, width: int, height: int, dilate: int = 15,
              device="cpu") -> np.ndarray:
    """Filled convex hull of projected points, dilated by a d x d box
    (anchor d // 2), as a bool (height, width) array."""
    mask = np.zeros((height, width), np.uint8)
    if len(uv) >= 3:
        pts = np.round(np.clip(uv, -COORD_LIMIT, COORD_LIMIT)).astype(np.int64)
        fill_convex_poly(mask, convex_hull(pts))
    if dilate > 0:
        a = dilate // 2
        m = torch.as_tensor(mask, device=device, dtype=torch.float32)[None, None]
        m = F.pad(m, (a, dilate - 1 - a, a, dilate - 1 - a))  # zeros: max of a 0/1 mask
        mask = F.max_pool2d(m, dilate, stride=1)[0, 0].cpu().numpy()
    return mask.astype(bool)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Build per-view edit-region masks for scene-update finetuning")
    p.add_argument("--data", type=Path, required=True, help="scene dir (COLMAP or transforms.json)")
    p.add_argument("--edit-object", type=Path, required=True)
    p.add_argument("--transform-npy", type=Path, required=True, help="4x4 rigid move (capture frame)")
    p.add_argument("--output", type=Path, default=None,
                   help="mask dir (default <data>/boundary_mask)")
    p.add_argument("--dilate", type=int, default=15)
    p.add_argument("--device", default="cuda", help="where the dilation runs: cuda (default) or cpu")
    args = p.parse_args(argv)

    from gaussiangrasper_torch.data.dataparsers.colmap import ColmapDataParser
    from gaussiangrasper_torch.data.dataparsers.transforms_json import TransformsJsonParser

    device = resolve_device(args.device)
    data = Path(args.data)
    if (data / "transforms.json").exists():
        outputs = TransformsJsonParser(data).parse()
    else:
        outputs = ColmapDataParser(data).parse()

    obj = (np.load(args.edit_object) if args.edit_object.suffix == ".npy"
           else np.loadtxt(args.edit_object))[:, :3]
    move = np.load(args.transform_npy)
    obj_after = obj @ move[:3, :3].T + move[:3, 3]

    out_dir = args.output or (data / "boundary_mask")
    out_dir.mkdir(parents=True, exist_ok=True)

    # the cameras are OpenGL c2w in the oriented world frame; the object
    # points are in the capture frame: move them as the parser moved the
    # cameras, then invert each pose in the OpenCV frame for projection
    wt = np.eye(4)
    wt[:3] = outputs.dataparser_transform
    s = outputs.dataparser_scale
    both = np.concatenate([obj, obj_after])
    both_w = (both @ wt[:3, :3].T + wt[:3, 3]) * s

    for cam, img_path in zip(outputs.cameras, outputs.image_filenames):
        c2w = np.eye(4)
        c2w[:3] = cam.camera_to_world
        c2w[:3, 1:3] *= -1.0  # OpenGL -> OpenCV
        w2c = np.linalg.inv(c2w)
        uv = project_points(both_w, w2c, cam.fx, cam.fy, cam.cx, cam.cy)
        mask = hull_mask(uv, cam.width, cam.height, args.dilate, device)
        np.save(out_dir / f"{img_path.stem}.npy", mask)
    print(f"wrote {len(outputs.cameras)} masks to {out_dir}")


if __name__ == "__main__":
    main()
