"""Open-vocabulary querying: CLIP relevancy maps from rendered features
(counterpart of the JAX package's scripts/query.py).

Renders the latent feature map of the chosen views, lifts it to CLIP space
with fea_up, and scores it against text embeddings with the LERF relevancy

  relevancy = min_i softmax(cos(f, q) / cos(f, canon_i))

Text embeddings come from --text-embedding (.npy of (512,) or (Q, 512)).
For each view v and query q it writes view<v>_q<q>.npy and a grayscale png.

    python -m gaussiangrasper_torch.scripts.query --run-dir RUN \
        --text-embedding q.npy [--canonical-embedding c.npy] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from gaussiangrasper_torch._device import full_f32, resolve_device
from gaussiangrasper_torch.engine.checkpoint import load_cameras, load_run
from gaussiangrasper_torch.scripts.render import lift, render_view
from gaussiangrasper_torch.utils.image_io import write_png


def relevancy_map(clip_map: torch.Tensor, query: torch.Tensor,
                  canonical: torch.Tensor) -> torch.Tensor:
    """LERF relevancy of an (H, W, 512) map against a (512,) query and
    (K, 512) canonical phrases: min over canonicals of the pairwise softmax."""
    f = clip_map / (torch.linalg.vector_norm(clip_map, dim=-1, keepdim=True) + 1e-8)
    q = query / (torch.linalg.vector_norm(query) + 1e-8)
    c = canonical / (torch.linalg.vector_norm(canonical, dim=-1, keepdim=True) + 1e-8)
    with full_f32():
        pos = f @ q  # (H, W)
        negs = f @ c.T  # (H, W, K)
    pair = torch.exp(pos)[..., None] / (torch.exp(pos)[..., None] + torch.exp(negs))
    return pair.min(dim=-1).values


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="CLIP-query a serving run")
    p.add_argument("--run-dir", type=Path, required=True)
    p.add_argument("--text", type=str, default=None)
    p.add_argument("--text-embedding", type=Path, default=None,
                   help=".npy (512,) or (Q,512) CLIP text embedding(s)")
    p.add_argument("--canonical-embedding", type=Path, default=None,
                   help=".npy (K,512) canonical-phrase embeddings")
    p.add_argument("--views", type=int, nargs="*", default=[0])
    p.add_argument("--output", type=Path, default=None)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.text_embedding is None:
        if args.text is not None:
            raise SystemExit("--text needs the CLIP text tower's weights, which are not "
                             "available here; pass --text-embedding with a precomputed .npy")
        raise SystemExit("give --text-embedding")
    device = resolve_device(args.device)
    cfg, state, _ = load_run(args.run_dir, device)
    cams, _ = load_cameras(args.run_dir, device)
    out_dir = args.output or (args.run_dir / "query")
    out_dir.mkdir(parents=True, exist_ok=True)

    q = torch.as_tensor(np.load(args.text_embedding).reshape(-1, 512), dtype=torch.float32,
                        device=device)
    if args.canonical_embedding is not None:
        canon = np.load(args.canonical_embedding)
    else:
        canon = np.zeros((1, 512), np.float32)  # degenerate -> plain cosine
    canon = torch.as_tensor(canon, dtype=torch.float32, device=device)

    for v in args.views:
        clip_map = lift(state.fea_up, render_view(state, cams[v], cfg)["feature"])
        for qi, qvec in enumerate(q):
            rel = relevancy_map(clip_map, qvec, canon).cpu().numpy()
            np.save(out_dir / f"view{v:04d}_q{qi}.npy", rel)
            write_png(out_dir / f"view{v:04d}_q{qi}.png",
                      (np.clip(rel, 0, 1) * 255).astype(np.uint8))
            ys, xs = np.nonzero(rel > args.threshold)
            if len(ys):
                print(f"view {v} query {qi}: peak {rel.max():.3f} at "
                      f"({ys.mean():.0f}, {xs.mean():.0f}), {len(ys)} px over thresh")
            else:
                print(f"view {v} query {qi}: peak {rel.max():.3f}, nothing over thresh")


if __name__ == "__main__":
    main()
