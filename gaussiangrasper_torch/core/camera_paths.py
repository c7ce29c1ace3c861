"""Camera trajectories for offline rendering (counterpart of the JAX
package's core/camera_paths.py; host numpy, the same arithmetic).

`interpolate_path` slerps the rotations and lerps the centres and focal
lengths between consecutive cameras; `spiral_path` circles a centre view
in its own image plane and returns to it. Both take and give the port's
`ParsedCamera`; `render --traj` and the viewer's `/render_path` render
them."""

from __future__ import annotations

from typing import List

import numpy as np

from gaussiangrasper_torch.data.dataparsers.base import ParsedCamera


def _slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def _rot_to_quat(r: np.ndarray) -> np.ndarray:
    w = np.sqrt(max(1.0 + r[0, 0] + r[1, 1] + r[2, 2], 1e-12)) / 2
    return np.array([
        w,
        (r[2, 1] - r[1, 2]) / (4 * w),
        (r[0, 2] - r[2, 0]) / (4 * w),
        (r[1, 0] - r[0, 1]) / (4 * w),
    ])


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def interpolate_path(cameras: List[ParsedCamera],
                     steps_per_transition: int = 10) -> List[ParsedCamera]:
    """`steps_per_transition` cameras from each camera towards the next
    (t = i / steps), then the last camera: 6 x (n - 1) + 1 at 6 steps."""
    out: List[ParsedCamera] = []
    for a, b in zip(cameras[:-1], cameras[1:]):
        qa = _rot_to_quat(a.camera_to_world[:3, :3])
        qb = _rot_to_quat(b.camera_to_world[:3, :3])
        for i in range(steps_per_transition):
            t = i / steps_per_transition
            pose = np.zeros((3, 4), np.float32)
            pose[:3, :3] = _quat_to_rot(_slerp(qa, qb, t))
            pose[:3, 3] = (1 - t) * a.camera_to_world[:3, 3] + t * b.camera_to_world[:3, 3]
            out.append(ParsedCamera(
                fx=(1 - t) * a.fx + t * b.fx, fy=(1 - t) * a.fy + t * b.fy,
                cx=a.cx, cy=a.cy, width=a.width, height=a.height, camera_to_world=pose))
    out.append(cameras[-1])
    return out


def spiral_path(center_camera: ParsedCamera, n_frames: int = 60, radius: float = 0.1,
                rotations: float = 2.0) -> List[ParsedCamera]:
    """`n_frames` cameras offset from the centre view in its own x / y
    plane by radius x sin(pi t) at angle 2 pi rotations t, t = i / n."""
    base = center_camera.camera_to_world
    r_mat = base[:3, :3]
    out = []
    for i in range(n_frames):
        t = i / n_frames
        ang = 2 * np.pi * rotations * t
        local = np.array([np.cos(ang), np.sin(ang), 0.0]) * radius * np.sin(np.pi * t)
        pose = base.copy()
        pose[:3, 3] = base[:3, 3] + r_mat @ local
        out.append(ParsedCamera(
            fx=center_camera.fx, fy=center_camera.fy, cx=center_camera.cx,
            cy=center_camera.cy, width=center_camera.width, height=center_camera.height,
            camera_to_world=pose.astype(np.float32)))
    return out
