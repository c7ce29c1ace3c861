"""Training CLI (counterpart of the JAX package's scripts/train.py).

    python -m gaussiangrasper_torch.scripts.train --data <scene_dir> \\
        [--output-dir outputs] [--max-iterations 30000] [--device cpu]

The JAX CLI's flags, plus --device (default cuda). Writes
<output-dir>/<experiment-name>/config.json and checkpoints/ (several
--data dirs: scene_<i>/checkpoints); render the run with
`python -m gaussiangrasper_torch.scripts.render --run-dir <that dir>`.
`--mesh dp,gauss` trains on dp x gauss ranks, which the CLI starts itself
(one process a card) unless it runs under torchrun.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a method with the PyTorch port")
    p.add_argument("--method", type=str, default="gaussian-splatting",
                   help="registered method name (configs/methods.py)")
    p.add_argument("--data", type=Path, required=True, nargs="+",
                   help="scene dir; several dirs train the scenes together (shared fea_up), "
                        "with --mesh over its dp ranks")
    p.add_argument("--dataparser", type=str, default="auto",
                   help="named dataparser (colmap, nerfstudio, blender, instant-ngp, minimal, "
                        "scannet, sdfstudio, arkitscenes, dnerf, phototourism, nuscenes, "
                        "dycheck, sitcoms3d, nerfosr, phototourism-raw) or 'auto' to detect "
                        "from the directory layout")
    p.add_argument("--viewer-port", type=int, default=None,
                   help="serve the live state to a browser on this port while training")
    p.add_argument("--mesh", type=str, default=None,
                   help="'dp,gauss' mesh for sharded training: dp x gauss ranks, one a card "
                        "(NCCL; gloo with --device cpu), started here unless under torchrun")
    p.add_argument("--tile-shard", type=str, default="auto", choices=("auto", "on", "off"),
                   help="with --mesh: composite each camera in bands over the gauss ranks "
                        "from a frustum-culled all-gather (auto: on when gauss > 1)")
    p.add_argument("--output-dir", type=Path, default=Path("outputs"))
    p.add_argument("--experiment-name", type=str, default="gaussian-splatting")
    p.add_argument("--max-iterations", type=int, default=30000)
    p.add_argument("--steps-per-save", type=int, default=2000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--capacity", type=int, default=None)
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--vis", type=str, default="",
                   help="extra metric backends, '+'-separated: tensorboard, wandb, comet "
                        "(missing libraries degrade with a notice)")
    p.add_argument("--load-dir", type=Path, default=None)
    p.add_argument("--profiler", type=str, default="none", choices=("none", "trace"),
                   help="'trace': a torch.profiler trace of steps 12..16 under "
                        "<run>/profiler_traces/, with the loop's and the step's ggt:: spans")
    p.add_argument("--feature-dim", type=int, default=32)
    p.add_argument("--sh-degree", type=int, default=4)
    p.add_argument("--max-tiles-per-gaussian", type=int, default=None,
                   help="binning cap on tiles one splat may cover (default 16); raise it "
                        "for high resolutions")
    p.add_argument("--warmup-length", type=int, default=500)
    p.add_argument("--refine-every", type=int, default=100)
    p.add_argument("--densify-grad-thresh", type=float, default=0.0002)
    p.add_argument("--sky-alpha-reg", type=float, default=0.0,
                   help="opt-in alpha penalty on masked-out pixels (0 = the reference loss set)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    """Run the method; returns what it returns (the Trainer, for
    gaussian-splatting)."""
    args = build_parser().parse_args(argv)

    from gaussiangrasper_torch.configs import get_method

    return get_method(args.method)(args)


if __name__ == "__main__":
    main()
