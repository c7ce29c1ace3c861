"""How far the card's float32 gradients of the ray-marched fields stray from
the CPU's, beside the CPU's own float32 spread, over several draw sets.

chip_smoke.py's nerf_zoo phase holds each field's gradient leaves, card
against CPU, within 1e-4 of the leaf's largest entry plus ZOO_GRAD_SPREAD
times the leaf's CPU float32 spread (chip_smoke.zoo_fields). This script
runs the same comparison on the trainer's 800x800 tabletop (view 0) first
as the phase does (every field, one draw sequence from seed 11), then for
each field alone at each of --seeds, and prints one JSON line a run (the
worst leaf's error over its bound, and the largest ratio of a leaf's card
error to its CPU spread), then one summary line. With --render-weights-f64
both devices compute the volume-rendering weights in float64, which shows
whether a field's gap lies in the weights' float32 rounding; with
--tf32-on-card the card's matmuls run in TF32 (full_f32 made a no-op that
allows it), which shows what the bound catches.

    python3 zoo_grad_spread.py [--seeds 11 12 13 14] [--fields tensorf ...]
        [--render-weights-f64] [--tf32-on-card]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
from pathlib import Path

from chip_smoke import TRAINER_SCENE, ZOO_FIELDS, ZOO_GRAD_SPREAD, zoo_fields

KEYS = ("within_bounds", "grad_worst_leaf", "grad_err_over_bound_f32",
        "grad_err_over_cpu_spread_max", "grad_rel_err_f32_max", "out_err_over_bound_f32")


def main(argv=None) -> int:
    import torch
    from gaussiangrasper_torch import _device
    from gaussiangrasper_torch.core.cameras import Camera
    from gaussiangrasper_torch.data.dataparsers.zoo import resolve_parser
    from gaussiangrasper_torch.data.synthetic import generate_tabletop
    from gaussiangrasper_torch.models import nerf

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[11, 12, 13, 14])
    p.add_argument("--fields", nargs="+", default=[label for label, _ in ZOO_FIELDS])
    p.add_argument("--render-weights-f64", action="store_true")
    p.add_argument("--tf32-on-card", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no cuda device", file=sys.stderr)
        return 1
    if args.render_weights_f64:
        weights = nerf.render_weights
        nerf.render_weights = lambda d, dl: weights(d.double(), dl.double()).to(d.dtype)
    if args.tf32_on_card:
        @contextlib.contextmanager
        def tf32():
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            yield

        _device.full_f32 = tf32
    with tempfile.TemporaryDirectory() as tmp:
        scene = generate_tabletop(Path(tmp) / "tabletop", **TRAINER_SCENE)
        pc = resolve_parser(scene).parse().cameras[0]
    cam = Camera.create(pc.fx, pc.fy, pc.cx, pc.cy, pc.camera_to_world, pc.width, pc.height)
    dev = torch.device("cuda")
    runs = [("sequence", 11, zoo_fields(cam, dev, check=False))]
    chosen = [case for case in ZOO_FIELDS if case[0] in args.fields]
    for seed in args.seeds:
        for case in chosen:
            runs.append(("alone", seed, zoo_fields(cam, dev, seed=seed, fields=[case], check=False)))
    worst = []
    for how, seed, rows in runs:
        for label, r in rows.items():
            if label in args.fields:
                print(json.dumps({"run": how, "seed": seed, "field": label,
                                  **{k: r[k] for k in KEYS}}), flush=True)
                worst.append((r["grad_err_over_cpu_spread_max"], label, how, seed))
    top = max(worst)
    print(json.dumps({"runs": len(worst), "out_of_bounds": sum(
        not rows[label]["within_bounds"] for _, _, rows in runs for label in rows
        if label in args.fields), "grad_spread_factor": ZOO_GRAD_SPREAD,
        "largest_card_err_over_cpu_spread": top[0], "at": top[1:],
        "render_weights_f64": args.render_weights_f64, "tf32_on_card": args.tf32_on_card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
