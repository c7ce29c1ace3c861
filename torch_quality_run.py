"""The 30k-step tabletop512 quality check of the PyTorch port.

Trains `ggt-torch-train` on the ray-traced tabletop at 512x512 and scores
the run on held-out views after each chunk, the port's counterpart of
`scripts_dev/r5_convergence.py` (docs/ROUND_NOTES.md, round 5 run 2):

- the train capture: 24 views alternating orbit heights 1.25 / 1.55,
  20000 seed points; the held-out capture: 4 views at height 1.4 and phase
  pi / 24, between the train views, never trained on;
- `--capacity 196608 --max-tiles-per-gaussian 36 --steps-per-save 2000`,
  in chunks to 10000 / 20000 / 30000 steps, each resuming the last
  checkpoint through `--load-dir`;
- after each chunk `ggt-torch-render --data <held-out> --num-views 4`
  (psnr_masked, ssim, psnr, depth_mae, normal_cos), and from the saved
  checkpoint the Gaussian count and the binning's drops on the 24 train
  views: `overflow`, the pairs past K = max_gaussians_per_tile (2048) in
  a tile, `dropped_tiles` past the tiles cap, `pair_overflow`.

One JSON a chunk (`step_<n>.json`) and `metrics.json` with all of them go
to --out. The target is the JAX run's held-out score
(docs/EVAL_r5_tabletop512_30k.json), printed beside the port's.

    python3 torch_quality_run.py [--out chiprun_out/quality] [--device cpu]

On one H100 the whole run takes about half an hour, in one run: a
resumed chunk needs the previous chunk's checkpoint.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
JAX_EVAL = ROOT / "docs" / "EVAL_r5_tabletop512_30k.json"
EVAL_KEYS = ("psnr_masked", "ssim", "psnr", "depth_mae", "normal_cos")
EXPERIMENT = "tabletop512"
MAX_TILES_PER_GAUSSIAN = 36
STEPS_PER_SAVE = 2000


def make_data(workdir: Path, size: int, train_views: int, seed_points: int,
              eval_views: int):
    from gaussiangrasper_torch.data.synthetic import generate_tabletop

    train = generate_tabletop(workdir / "scene", width=size, height=size, n_views=train_views,
                              feature_downscale=4, seed_points=seed_points,
                              view_height=(1.25, 1.55))
    held_out = generate_tabletop(workdir / "scene_eval", width=size, height=size,
                                 n_views=eval_views, feature_downscale=4, seed_points=64,
                                 view_phase=float(np.pi / train_views), view_height=1.4)
    return train, held_out


def run(cmd: list) -> float:
    """Run one CLI to its end from the repo root; its wall seconds."""
    print("RUN:", " ".join(map(str, cmd)), flush=True)
    t0 = time.perf_counter()
    subprocess.run([str(c) for c in cmd], cwd=ROOT, check=True)
    return time.perf_counter() - t0


def train_view_binning(run_dir: Path, views: int, device) -> dict:
    """The latest checkpoint's Gaussian count and what binning drops on
    each train view at full resolution: neither trainer logs it."""
    import torch

    from gaussiangrasper_torch.models.model import render_inputs
    from gaussiangrasper_torch.ops.rasterize import bin_gaussians
    from gaussiangrasper_torch.scripts.render import load_trainer_run

    cfg, state, _, cams, _ = load_trainer_run(run_dir, views, device)
    per_view = []
    with torch.no_grad():
        for cam in cams:
            proj, _, opac, _ = render_inputs(state.field, state.alive, cam, state.step, cfg)
            bins = bin_gaussians(proj, cam.width, cam.height, cfg.raster, opacities=opac,
                                 build_table=False, keep_pairs=True)
            per_view.append({k: int(getattr(bins, k))
                             for k in ("overflow", "dropped_tiles", "pair_overflow")})
    out = {"step": int(state.step), "count": int(state.alive.sum()),
           "capacity": int(state.alive.numel()), "views": len(per_view),
           "max_gaussians_per_tile": cfg.raster.max_gaussians_per_tile,
           **{f"{k}_total": sum(v[k] for v in per_view) for k in per_view[0]},
           "overflow_max_view": max(v["overflow"] for v in per_view), "per_view": per_view}
    del state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def nvidia_smi() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not available"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "quality")
    p.add_argument("--workdir", type=Path, default=None,
                   help="captures, run and renders (default: a temporary directory)")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--until", type=int, nargs="+", default=[10000, 20000, 30000],
                   help="the chunks' cumulative step targets")
    p.add_argument("--capacity", type=int, default=196608)
    p.add_argument("--train-views", type=int, default=24)
    p.add_argument("--eval-views", type=int, default=4)
    p.add_argument("--seed-points", type=int, default=20000)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from gaussiangrasper_torch._device import resolve_device

    device = resolve_device(args.device)
    args.out.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        workdir = args.workdir or Path(tmp)
        workdir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        train, held_out = make_data(workdir, args.size, args.train_views, args.seed_points,
                                    args.eval_views)
        data_s = time.perf_counter() - t0
        print(f"data generated in {data_s:.1f}s", flush=True)
        run_dir = workdir / "runs" / EXPERIMENT
        ckpt_dir = run_dir / "checkpoints"
        chunks, prev = [], 0
        for until in args.until:
            cmd = [sys.executable, "-m", "gaussiangrasper_torch.scripts.train",
                   "--data", train, "--output-dir", workdir / "runs",
                   "--experiment-name", EXPERIMENT, "--max-iterations", until,
                   "--steps-per-save", STEPS_PER_SAVE, "--capacity", args.capacity,
                   "--max-tiles-per-gaussian", MAX_TILES_PER_GAUSSIAN,
                   "--device", args.device]
            if ckpt_dir.exists() and any(ckpt_dir.iterdir()):
                cmd += ["--load-dir", ckpt_dir]
            train_s = run(cmd)
            eval_dir = workdir / f"eval_{until}"
            eval_s = run([sys.executable, "-m", "gaussiangrasper_torch.scripts.render",
                          "--run-dir", run_dir, "--data", held_out,
                          "--num-views", args.eval_views, "--output", eval_dir,
                          "--device", args.device])
            results = json.loads((eval_dir / "metrics.json").read_text())["results"]
            chunk = {"step": until, "steps": until - prev, "train_wall_s": train_s,
                     "train_wall_ms_per_step": 1e3 * train_s / (until - prev),
                     "eval_wall_s": eval_s, "held_out": {k: results[k] for k in EVAL_KEYS
                                                         if k in results},
                     "held_out_per_view": results["per_view"],
                     "train_views": train_view_binning(run_dir, args.train_views, device)}
            for k in ("depth_mae", "normal_cos"):
                vals = [v[k] for v in results["per_view"] if k in v]
                if vals:
                    chunk["held_out"][k] = float(np.mean(vals))
            (args.out / f"step_{until}.json").write_text(json.dumps(chunk, indent=2))
            print("HELD-OUT EVAL:", json.dumps({"step": until, **chunk["held_out"],
                                               "count": chunk["train_views"]["count"],
                                               "overflow": chunk["train_views"]["overflow_total"]}),
                  flush=True)
            chunks.append(chunk)
            prev = until
    target = (json.loads(JAX_EVAL.read_text())["results"] if JAX_EVAL.exists() else {})
    summary = {
        "device": nvidia_smi() if device.type == "cuda" else "cpu",
        "setting": {"size": args.size, "train_views": args.train_views,
                    "eval_views": args.eval_views, "seed_points": args.seed_points,
                    "capacity": args.capacity,
                    "max_tiles_per_gaussian": MAX_TILES_PER_GAUSSIAN,
                    "steps_per_save": STEPS_PER_SAVE, "chunks": args.until},
        "data_s": data_s,
        "jax_target": {k: target[k] for k in ("psnr_masked", "ssim", "psnr") if k in target},
        "chunks": chunks,
    }
    (args.out / "metrics.json").write_text(json.dumps(summary, indent=2))
    last = chunks[-1]["held_out"]
    print("FINAL:", json.dumps({"step": chunks[-1]["step"], **last,
                                "jax_target": summary["jax_target"]}), flush=True)
    if not all(math.isfinite(v) for c in chunks for v in c["held_out"].values()):
        print("non-finite held-out metrics", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
