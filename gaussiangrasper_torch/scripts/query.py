"""Open-vocabulary querying: CLIP relevancy maps from rendered features
(counterpart of the JAX package's scripts/query.py).

Renders the latent feature map of the chosen views, lifts it to CLIP space
with fea_up, and scores it against text embeddings with the LERF relevancy

  relevancy = min_i softmax(cos(f, q) / cos(f, canon_i))

Text embeddings come from --text-embedding (.npy of (512,) or (Q, 512)) or
from --text, encoded by CLIP ViT-B/16's text tower (`models/clip_text.py`,
the port's own modules on --device) from the cached hub snapshot of
openai/clip-vit-base-patch16 (`utils/hub_snapshot.py`); with --text and no
--canonical-embedding the canonical phrases are encoded too. Without a
snapshot --text exits naming the paths searched. For each view v and query
q it writes view<v>_q<q>.npy and a grayscale png.
The run is a serving run (checkpoint.pt and cameras.npz) or a trainer run
(its latest checkpoint and its capture's cameras, as the JAX CLI reads it).

    python -m gaussiangrasper_torch.scripts.query --run-dir RUN \
        (--text "a red mug" | --text-embedding q.npy) [--canonical-embedding c.npy] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from gaussiangrasper_torch._device import full_f32, resolve_device
from gaussiangrasper_torch.engine.checkpoint import CHECKPOINT, load_cameras, load_run
from gaussiangrasper_torch.models.clip_text import ClipTextEncoder
from gaussiangrasper_torch.scripts.render import lift, load_trainer_run, render_view
from gaussiangrasper_torch.utils import hub_snapshot
from gaussiangrasper_torch.utils.image_io import write_png
from gaussiangrasper_torch.utils.profiler import PROFILER

CLIP_MODEL = "openai/clip-vit-base-patch16"
CANONICAL_PHRASES = ("object", "things", "stuff", "texture")


def encode_text(prompts, device=None, encoder=None) -> np.ndarray:
    """CLIP ViT-B/16 text features (len(prompts), 512) as float32 numpy.
    encoder: a loaded ClipTextEncoder (None loads the cached snapshot of
    CLIP_MODEL on `device`, None meaning cuda; raises
    hub_snapshot.SnapshotNotFound)."""
    if encoder is None:
        encoder = ClipTextEncoder.from_name(CLIP_MODEL, resolve_device(device))
    return encoder(list(prompts)).cpu().numpy()


def relevancy_map(clip_map: torch.Tensor, query: torch.Tensor,
                  canonical: torch.Tensor) -> torch.Tensor:
    """LERF relevancy of an (H, W, 512) map against a (512,) query and
    (K, 512) canonical phrases: min over canonicals of the pairwise softmax
    (the span `relevancy`)."""
    with PROFILER.section("relevancy"):
        f = clip_map / (torch.linalg.vector_norm(clip_map, dim=-1, keepdim=True) + 1e-8)
        q = query / (torch.linalg.vector_norm(query) + 1e-8)
        c = canonical / (torch.linalg.vector_norm(canonical, dim=-1, keepdim=True) + 1e-8)
        with full_f32():
            pos = f @ q  # (H, W)
            negs = f @ c.T  # (H, W, K)
        pair = torch.exp(pos)[..., None] / (torch.exp(pos)[..., None] + torch.exp(negs))
        return pair.min(dim=-1).values


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="CLIP-query a serving or trainer run")
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

    if args.text_embedding is None and args.text is None:
        raise SystemExit("give --text or --text-embedding")
    device = resolve_device(args.device)
    encoder = None
    if args.text_embedding is None:  # --text: the tower encodes it
        try:
            encoder = ClipTextEncoder.from_name(CLIP_MODEL, device)
        except hub_snapshot.SnapshotNotFound as e:
            raise SystemExit(f"--text needs the CLIP text tower's weights ({e}); "
                             "pass --text-embedding with a precomputed .npy")
    if (args.run_dir / CHECKPOINT).exists():
        cfg, state, _ = load_run(args.run_dir, device)
        cams, _ = load_cameras(args.run_dir, device)
    else:
        cfg, state, _, cams, _ = load_trainer_run(args.run_dir, max(args.views) + 1, device)
    out_dir = args.output or (args.run_dir / "query")
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.text_embedding is not None:
        q = np.load(args.text_embedding).reshape(-1, 512)
    else:
        q = encode_text([args.text], encoder=encoder)
    if args.canonical_embedding is not None:
        canon = np.load(args.canonical_embedding)
    elif args.text is not None and args.text_embedding is None:
        canon = encode_text(CANONICAL_PHRASES, encoder=encoder)
    else:
        canon = np.zeros((1, 512), np.float32)  # degenerate -> plain cosine
    q = torch.as_tensor(q, dtype=torch.float32, device=device)
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
