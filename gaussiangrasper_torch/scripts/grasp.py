"""Open-vocabulary grasp proposal from the trained field (counterpart of the
JAX package's scripts/grasp.py).

1. Lift every Gaussian's latent feature through the trained fea_up MLP and
   score it against the query CLIP embedding (the LERF relevancy of
   scripts/query.py);
2. keep the alive Gaussians above --threshold and their largest spatial
   cluster (26-connected components on a voxel grid);
3. propose a grasp: position = opacity-weighted centroid, approach =
   against the dominant surface normal (the smallest-scale axes,
   sign-aligned), closing axis and width from the cluster's spread
   perpendicular to it.

`grasp_request` is one served request, from a loaded state and a query
embedding to the grasp dict; `main` calls it and writes the files. Spans
(`utils/profiler.PROFILER`, on only while a torch.profiler records):
`grasp/relevancy`, `grasp/cluster` and `grasp/propose`; counters
`grasp/selected` (Gaussians above the threshold) and `grasp/voxels` (their
occupied voxels).

Writes <output>/grasp.json {position, approach, axis, width, score,
num_gaussians} and <output>/selected.ply.

    python -m gaussiangrasper_torch.scripts.grasp --run-dir RUN \\
        --text-embedding q.npy [--canonical-embedding c.npy] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from gaussiangrasper_torch._device import full_f32, resolve_device
from gaussiangrasper_torch.models.efd import mlp_apply
from gaussiangrasper_torch.models.model import smallest_axis_normals
from gaussiangrasper_torch.scripts.common import load_run
from gaussiangrasper_torch.scripts.export_pointcloud import write_ply_points
from gaussiangrasper_torch.utils.profiler import PROFILER


def gaussian_relevancy(fea_up: Mapping[str, torch.Tensor], features: torch.Tensor,
                       query: torch.Tensor, canonical: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian relevancy in [0, 1]: min over the canonical phrases of
    the pairwise softmax. In full float32: at 400k Gaussians TF32 would
    move the scores."""
    with torch.no_grad(), full_f32():
        lifted = mlp_apply(fea_up, features)  # (N, 512)
        f = lifted / (torch.linalg.vector_norm(lifted, dim=-1, keepdim=True) + 1e-8)
        q = query / (torch.linalg.vector_norm(query) + 1e-8)
        c = canonical / (torch.linalg.vector_norm(canonical, dim=-1, keepdim=True) + 1e-8)
        pos = f @ q
        negs = f @ c.T  # (N, K)
        pair = torch.exp(pos)[:, None] / (torch.exp(pos)[:, None] + torch.exp(negs))
        return pair.min(dim=-1).values


def largest_cluster(points: np.ndarray, voxel: float = 0.02) -> np.ndarray:
    """Mask of the largest 26-connected voxel component (union-find; ties
    go to the smallest root, as `np.bincount(...).argmax()` takes it)."""
    if len(points) == 0:
        return np.zeros(0, bool)
    idx = np.floor(points / voxel).astype(np.int64)
    idx -= idx.min(0)
    dims = idx.max(0) + 1
    lin = np.ravel_multi_index(idx.T, dims)
    occupied = np.unique(lin)
    PROFILER.count("grasp/voxels", len(occupied))
    parent = np.arange(len(occupied))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    occ3 = np.stack(np.unravel_index(occupied, dims), -1)
    occ_set = {tuple(v): i for i, v in enumerate(occ3)}
    for i, v in enumerate(occ3):
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dx == dy == dz == 0:
                        continue
                    j = occ_set.get((v[0] + dx, v[1] + dy, v[2] + dz))
                    if j is not None:
                        ra, rb = find(i), find(j)
                        if ra != rb:
                            parent[ra] = rb
    roots = np.array([find(i) for i in range(len(occupied))])
    labels = roots[np.searchsorted(occupied, lin)]
    return labels == np.bincount(labels).argmax()


def propose_grasp(points: np.ndarray, normals: np.ndarray, opacities: np.ndarray) -> dict:
    """Grasp pose from a selected cluster."""
    w = opacities / (opacities.sum() + 1e-9)
    center = (points * w[:, None]).sum(0)
    # dominant surface normal: sign-align, then average
    ref = normals[np.argmax(opacities)]
    aligned = normals * np.sign(normals @ ref)[:, None]
    approach = aligned.mean(0)
    approach /= np.linalg.norm(approach) + 1e-9
    # closing axis: the largest-variance direction perpendicular to approach
    centered = points - center
    perp = centered - np.outer(centered @ approach, approach)
    cov = perp.T @ perp / max(len(points), 1)
    _, vecs = np.linalg.eigh(cov)
    axis = vecs[:, -1]
    extent = perp @ axis
    width = float(np.percentile(extent, 95) - np.percentile(extent, 5))
    return {
        "position": center.tolist(),
        "approach": (-approach).tolist(),  # move against the surface normal
        "axis": axis.tolist(),
        "width": width,
    }


def grasp_request(state, query: torch.Tensor, canonical: torch.Tensor,
                  threshold: float = 0.6, voxel: float = 0.02) -> dict:
    """One grasp request on a loaded state (anything with `field`, `alive`
    and `fea_up`, the latter a FeaUp or its parameter dict): the grasp.json
    payload, plus `selected` and `cluster`, the indices of the Gaussians
    above `threshold` and of those in its largest cluster. Exits where no
    Gaussian is above `threshold`."""
    field, fea_up = state.field, state.fea_up
    if isinstance(fea_up, torch.nn.Module):
        fea_up = fea_up.state_dict()
    with PROFILER.section("grasp/relevancy"):
        alive = state.alive.cpu().numpy()
        rel = gaussian_relevancy(fea_up, field.features, query, canonical).cpu().numpy()
    sel = alive & (rel > threshold)
    if not sel.any():
        raise SystemExit(f"no gaussians above relevancy {threshold} "
                         f"(max {rel[alive].max():.3f})")
    PROFILER.count("grasp/selected", int(sel.sum()))
    selected = np.flatnonzero(sel)
    with PROFILER.section("grasp/cluster"):
        means = field.means.cpu().numpy()
        cluster = largest_cluster(means[sel], voxel)
    with PROFILER.section("grasp/propose"), torch.no_grad():
        idx = selected[cluster]
        normals = smallest_axis_normals(field.log_scales, field.quats).cpu().numpy()
        opac = torch.sigmoid(field.opacity_logits).cpu().numpy()
        grasp = propose_grasp(means[idx], normals[idx], opac[idx])
    grasp["score"] = float(rel[idx].mean())
    grasp["num_gaussians"] = int(cluster.sum())
    grasp["selected"] = selected
    grasp["cluster"] = idx
    return grasp


def main(argv=None) -> dict:
    """Propose a grasp; returns the grasp.json payload."""
    p = argparse.ArgumentParser(description="Open-vocabulary grasp proposal")
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--text-embedding", type=Path, required=True,
                   help=".npy (512,) CLIP text embedding of the object")
    p.add_argument("--canonical-embedding", type=Path, default=None)
    p.add_argument("--threshold", type=float, default=0.6)
    p.add_argument("--voxel", type=float, default=0.02)
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    _, _, state = load_run(args.run_dir, device=device)
    query = torch.as_tensor(np.load(args.text_embedding).reshape(-1)[:512], dtype=torch.float32,
                            device=device)
    canon = (np.load(args.canonical_embedding) if args.canonical_embedding is not None
             else np.zeros((1, 512), np.float32))
    canon = torch.as_tensor(canon, dtype=torch.float32, device=device)

    grasp = grasp_request(state, query, canon, args.threshold, args.voxel)
    del grasp["selected"]
    pts = state.field.means.cpu().numpy()[grasp.pop("cluster")]

    out_dir = args.output or (args.run_dir / "grasp")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "grasp.json").write_text(json.dumps(grasp, indent=2))
    write_ply_points(out_dir / "selected.ply", pts, np.tile([255, 64, 64], (len(pts), 1)))
    print(json.dumps(grasp, indent=2))
    return grasp


if __name__ == "__main__":
    main()
