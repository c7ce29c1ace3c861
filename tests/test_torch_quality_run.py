"""torch_quality_run.py (the port's 30k-step tabletop512 quality check),
driven for a handful of steps at 32x32 on the CPU so that the script
cannot rot: two chunks, the second resuming the first's checkpoint through
`--load-dir`, each followed by the held-out eval through the render CLI and
the train views' binning drops read from the checkpoint."""

import importlib.util
import json
import math
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_quality_run_small_on_cpu(tmp_path):
    spec = importlib.util.spec_from_file_location("torch_quality_run", ROOT / "torch_quality_run.py")
    qr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(qr)
    out = tmp_path / "out"
    rc = qr.main(["--out", str(out), "--workdir", str(tmp_path / "work"), "--size", "32",
                  "--until", "2", "4", "--capacity", "2048", "--train-views", "4",
                  "--eval-views", "2", "--seed-points", "300", "--device", "cpu"])
    assert rc == 0
    summary = json.loads((out / "metrics.json").read_text())
    assert summary["setting"]["chunks"] == [2, 4] and summary["device"] == "cpu"
    assert summary["jax_target"]["psnr_masked"] > 20  # docs/EVAL_r5_tabletop512_30k.json
    assert [c["step"] for c in summary["chunks"]] == [2, 4]
    for chunk in summary["chunks"]:
        assert chunk == json.loads((out / f"step_{chunk['step']}.json").read_text())
        assert chunk["steps"] == 2 and len(chunk["held_out_per_view"]) == 2
        assert set(chunk["held_out"]) == {"psnr_masked", "ssim", "psnr", "depth_mae",
                                          "normal_cos"}
        assert all(math.isfinite(v) for v in chunk["held_out"].values())
        tv = chunk["train_views"]
        assert tv["step"] == chunk["step"] and tv["views"] == 4 and len(tv["per_view"]) == 4
        assert 0 < tv["count"] <= tv["capacity"] == 2048
        assert tv["overflow_total"] == sum(v["overflow"] for v in tv["per_view"]) >= 0
    runs = tmp_path / "work" / "runs" / "tabletop512" / "checkpoints"
    assert sorted(p.name for p in runs.iterdir())[-1].endswith("4.pt")
