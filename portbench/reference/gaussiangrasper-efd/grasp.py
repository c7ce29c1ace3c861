"""The grasp request of the reference, written from its definitions:
per-Gaussian relevancy, the selection above a threshold, its largest
26-connected voxel cluster and the grasp pose.

- The lift is fea_up's MLP as matrix products: a ReLU after every layer
  but the last.
- The relevancy is LERF's: the least, over the canonical phrases, of the
  softmax of the lifted feature's cosine to the query against its cosine
  to the phrase, which is the logistic of the query's cosine less the
  largest phrase cosine.
- The cluster is `scipy.ndimage.label` with a 3x3x3 structure on the dense
  grid of occupied voxels, the largest component taken (a tie goes to the
  lowest label, in the grid's raster order, where the program's goes to
  its smallest root: ties are not expected at the benchmark's sizes).
- A Gaussian's normal is its unit quaternion's rotation, v + 2w(u x v) +
  2u x (u x v), of the basis vector of its smallest scale (the first on a
  tie), in float64.
- The pose, in float64: the position is the opacity-weighted centroid;
  the approach is against the mean of the normals, each turned to the side
  of the most opaque Gaussian's (one at right angles to it left out); the
  closing axis is the first right singular vector of the points' offsets
  from the centroid with their part along the approach taken off; the width
  is the 5-95 percentile range of the offsets along that axis.

Departures from the program: float64 for the normals and the pose where the
program stays in float32, and a singular value decomposition where it
takes the eigenvectors of the spread's covariance. Imports nothing of
gaussiangrasper_torch or JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from scipy import ndimage


def lift(fea_up: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """fea_up's MLP on `x`: (N, d_in) -> (N, d_out)."""
    n = len(fea_up) // 2
    for i in range(n):
        x = x @ fea_up[f"layers.{i}.weight"].T + fea_up[f"layers.{i}.bias"]
        if i < n - 1:
            x = x.clamp_min(0.0)
    return x


def relevancy(fea_up: Mapping[str, torch.Tensor], features: torch.Tensor, query: torch.Tensor,
              canonical: torch.Tensor) -> torch.Tensor:
    """(N,) relevancy in [0, 1]."""
    with torch.no_grad():
        f = lift(fea_up, features)
        f = f / f.norm(dim=-1, keepdim=True)
        q = query / query.norm()
        c = canonical / canonical.norm(dim=-1, keepdim=True)
        return torch.sigmoid(f @ q - (f @ c.T).max(dim=-1).values)


def largest_cluster(points: np.ndarray, voxel: float) -> np.ndarray:
    """Mask of the points in the largest 26-connected component of their
    occupied voxels."""
    if len(points) == 0:
        return np.zeros(0, bool)
    idx = np.floor(points / voxel).astype(np.int64)
    idx -= idx.min(0)
    grid = np.zeros(idx.max(0) + 1, bool)
    grid[tuple(idx.T)] = True
    labels, n = ndimage.label(grid, structure=np.ones((3, 3, 3), int))
    of_point = labels[tuple(idx.T)]
    sizes = np.bincount(of_point, minlength=n + 1)
    sizes[0] = 0
    return of_point == int(np.argmax(sizes))


def normals(log_scales: np.ndarray, quats: np.ndarray) -> np.ndarray:
    """(N, 3) unit normals: each quaternion's rotation of the basis vector
    of its smallest scale."""
    q = quats.astype(np.float64)
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    w, u = q[:, :1], q[:, 1:]
    v = np.eye(3)[np.argmin(log_scales, axis=1)]
    uv = np.cross(u, v)
    return v + 2.0 * w * uv + 2.0 * np.cross(u, uv)


def propose(points: np.ndarray, normal: np.ndarray, opacities: np.ndarray) -> dict:
    """The pose of a cluster from its points, normals and opacities."""
    p, n, o = (np.asarray(a, np.float64) for a in (points, normal, opacities))
    position = np.average(p, axis=0, weights=o)
    side = np.sign(n @ n[np.argmax(o)])
    mean = (n * side[:, None]).sum(0)
    approach = -mean / np.linalg.norm(mean)
    off = p - position
    perp = off - np.outer(off @ approach, approach)
    axis = np.linalg.svd(perp, full_matrices=False)[2][0]
    lo, hi = np.percentile(perp @ axis, [5, 95])
    return {"position": position.tolist(), "approach": approach.tolist(), "axis": axis.tolist(),
            "width": float(hi - lo)}


def request(field, alive: torch.Tensor, fea_up: Mapping[str, torch.Tensor], query: torch.Tensor,
            canonical: torch.Tensor, threshold: float, voxel: float) -> dict:
    """The grasp dict of one query, with the relevancy and the indices of
    the selected Gaussians and of the cluster."""
    rel = relevancy(fea_up, field.features, query, canonical).cpu().numpy()
    sel = np.flatnonzero(alive.cpu().numpy() & (rel > threshold))
    means = field.means.cpu().numpy()
    idx = sel[largest_cluster(means[sel], voxel)]
    opac = 1.0 / (1.0 + np.exp(-field.opacity_logits.cpu().numpy()[idx].astype(np.float64)))
    out = propose(means[idx], normals(field.log_scales.cpu().numpy()[idx],
                                      field.quats.cpu().numpy()[idx]), opac)
    out.update(score=float(rel[idx].mean()), num_gaussians=int(len(idx)), relevancy=rel,
               selected=sel, cluster=idx)
    return out
