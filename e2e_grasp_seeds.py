"""The end-to-end tabletop test's grasp at several trainer seeds, through
the JAX package.

tests/test_e2e_tabletop.py trains a 64x64, six-view tabletop for 300 steps
(feature 16, its RasterizeConfig), runs the grasp CLI with sphere 1's
synthetic CLIP vector against the other three at threshold 0.5, and asks
that the grasp lie within 3 sphere radii of sphere 1's centre. This script
repeats that train and grasp at each of chip_smoke.py's E2E_SEEDS (the same
setting, from chip_smoke.py's E2E constants) and prints one JSON line a seed
(the distance in radii, the height of the grasp above the table, the
cluster's size), then one summary line. chip_smoke.py's e2e_small phase runs
the same sweep through the PyTorch port on the card and holds its misses to
this one's (E2E_JAX_GRASP_MISSES).

    JAX_PLATFORMS=cpu python3 e2e_grasp_seeds.py [--seeds 42 0 1 ...]
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np

from chip_smoke import E2E, E2E_MODEL, E2E_RASTER, E2E_SEEDS, E2E_STEPS


def main(argv=None) -> int:
    from gaussiangrasper_tpu.data.synthetic import SPHERES, clip_vectors, generate_tabletop
    from gaussiangrasper_tpu.engine.trainer import TrainerConfig, make_trainer
    from gaussiangrasper_tpu.models.model import GaussianSplatConfig
    from gaussiangrasper_tpu.ops.rasterize import RasterizeConfig
    from gaussiangrasper_tpu.scripts import grasp

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=list(E2E_SEEDS))
    args = p.parse_args(argv)
    model = GaussianSplatConfig(raster=RasterizeConfig(**E2E_RASTER), **E2E_MODEL)

    clips = clip_vectors()
    c1, r1, _ = SPHERES[1]
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        scene = generate_tabletop(tmp / "scene", **E2E)
        np.save(tmp / "q.npy", clips[1])
        np.save(tmp / "canon.npy", np.stack([clips[0], clips[2], clips[3]]))
        for seed in args.seeds:
            cfg = TrainerConfig(data=scene, output_dir=tmp / f"runs{seed}",
                                experiment_name="tabletop", max_iterations=E2E_STEPS,
                                steps_per_save=E2E_STEPS, capacity=4096, prefetch=False, seed=seed,
                                model=model)
            trainer = make_trainer(cfg)
            trainer.setup()
            # the test draws view 0's batch for its PSNR baseline before
            # training, which moves the datamanager's later draws
            trainer.dm.get_batch(0)
            trainer.train()
            grasp.main(["--run-dir", str(cfg.run_dir), "--text-embedding", str(tmp / "q.npy"),
                        "--canonical-embedding", str(tmp / "canon.npy"), "--threshold", "0.5",
                        "--output", str(tmp / f"grasp{seed}")])
            g = json.loads((tmp / f"grasp{seed}" / "grasp.json").read_text())
            # the grasp is in the model (dataparser-oriented, scaled) frame
            tf = np.asarray(trainer.dm.outputs.dataparser_transform)
            sc = float(trainer.dm.outputs.dataparser_scale)
            pos = np.asarray(g["position"])
            table = tf[:, 3] * sc
            up = tf[:, 2] / np.linalg.norm(tf[:, 2])
            row = {"seed": seed,
                   "distance_radii": float(np.linalg.norm(pos - (tf[:, :3] @ c1 + tf[:, 3]) * sc)
                                           / (r1 * sc)),
                   "height_above_table_radii": float((pos - table) @ up / (r1 * sc)),
                   "num_gaussians": g["num_gaussians"], "score": g["score"]}
            print(json.dumps(row), flush=True)
            rows.append(row)
    misses = [r["seed"] for r in rows if not r["distance_radii"] < 3]
    print(json.dumps({"seeds": args.seeds, "missed_3_radii": misses,
                      "distance_radii": [r["distance_radii"] for r in rows]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
