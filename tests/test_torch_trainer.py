"""PyTorch port vs the JAX package: the trainer, the training CLI and the
two-tile compositor setting.

- Five trainer steps on a ray-traced tabletop (64x48, 4 views) from one
  JAX-initialized state carried into the port: steps 0-1 at half
  resolution, 2-4 at full, a refine after step 2, the same camera order and
  draws. Metrics at atol 1e-6 / rtol 1e-4 and parameters at 2 lr N, the
  tolerances of tests/test_torch_train.py's three train steps (float32 sums
  in another order; Adam with eps 1e-15 moves a near-zero-gradient entry by
  about +-lr on a sign that rounding can flip).
- TP = 2 (K5 / K6's setting): on CPU tensors the port runs K1 / K2's plain
  versions, held against the JAX two-tile kernels `_call_fwd_pairs2` /
  `_call_bwd_pairs2` in interpret mode on an odd tile count (96x80 at tile
  32: 9 tiles), at the K1 / K2 tolerances of tests/test_torch_rasterize.py
  and tests/test_torch_train.py.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiangrasper_torch import _build
from gaussiangrasper_torch.configs import get_method
from gaussiangrasper_torch.engine import optimizers as topt
from gaussiangrasper_torch.engine import train_state as tts
from gaussiangrasper_torch.engine.trainer import TrainerConfig as TTrainerConfig
from gaussiangrasper_torch.engine.trainer import _downscale_factor
from gaussiangrasper_torch.engine.trainer import make_trainer as t_make_trainer
from gaussiangrasper_torch.models.gaussian_field import FIELD_KEYS
from gaussiangrasper_torch.models.model import GaussianSplatConfig as TConfig
from gaussiangrasper_torch.ops import rasterize_cuda as rc
from gaussiangrasper_torch.ops.rasterize import RasterizeConfig as TRC
from gaussiangrasper_torch.scripts import common as tcommon
from gaussiangrasper_torch.scripts import render as t_render_cli
from gaussiangrasper_torch.scripts import train as t_train_cli
from gaussiangrasper_torch.utils.image_io import read_png
from gaussiangrasper_tpu.data.synthetic import generate_tabletop
from gaussiangrasper_tpu.engine import trainer as jtrainer
from gaussiangrasper_tpu.models.model import GaussianSplatConfig as JConfig
from gaussiangrasper_tpu.ops import rasterize_pallas as rp
from gaussiangrasper_tpu.ops.rasterize import RasterizeConfig as JRC
from gaussiangrasper_tpu.ops.rasterize import bin_gaussians as j_bin
from gaussiangrasper_tpu.scripts.common import config_from_json as j_config_from_json
from tests.test_torch_core import T, close, make_scene, project_both
from tests.test_torch_train import close_scaled, convert

STEPS = 5
SMALL_MODEL = dict(feature_dim=16, sh_degree=1, num_downscales=1, resolution_schedule=2,
                   warmup_length=30, refine_every=3, stop_split_at=300)
SMALL_RASTER = dict(tile_size=16, max_gaussians_per_tile=1024, tile_chunk=4,
                    max_tiles_per_gaussian=16)
CLI_ARGS = ["--capacity", "4096", "--feature-dim", "16", "--sh-degree", "1",
            "--max-tiles-per-gaussian", "16", "--device", "cpu"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return generate_tabletop(tmp_path_factory.mktemp("tabletop") / "scene", width=64, height=48,
                             n_views=4, feature_downscale=2)


def trainer_kwargs(scene, out, name):
    return dict(data=scene, output_dir=out, experiment_name=name, max_iterations=STEPS,
                steps_per_save=STEPS, capacity=4096)


@pytest.fixture(scope="module")
def five_steps(scene, tmp_path_factory):
    """The JAX trainer and the port's, from one JAX-initialized state, five
    steps each; per-step metrics recorded around each package's train_step."""
    out = tmp_path_factory.mktemp("runs")
    jcfg = jtrainer.TrainerConfig(**trainer_kwargs(scene, out, "jax"), prefetch=False,
                                  model=JConfig(raster=JRC(**SMALL_RASTER), **SMALL_MODEL))
    tcfg = TTrainerConfig(**trainer_kwargs(scene, out, "torch"),
                          model=TConfig(raster=TRC(**SMALL_RASTER), **SMALL_MODEL))
    jt = jtrainer.make_trainer(jcfg)
    jstate0 = jt.setup()
    tt = t_make_trainer(tcfg, device="cpu")
    tt.state = convert(jstate0)

    jm, tm = [], []
    j_step, t_step = jtrainer.train_step, tts.train_step

    def j_spy(*a, **k):
        state, m = j_step(*a, **k)
        jm.append((a[1].width, jax.tree.map(np.array, m)))
        return state, m

    def t_spy(*a, **k):
        state, m = t_step(*a, **k)
        tm.append((a[1].width, m))
        return state, m

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "train_step", j_spy)
        mp.setattr(tts, "train_step", t_spy)
        jstate = jax.tree.map(np.array, jt.train())
        tstate = tt.train()
    return dict(jm=jm, tm=tm, jstate=jstate, tstate=tstate, jt=jt, tt=tt, jcfg=jcfg, tcfg=tcfg)


def test_five_trainer_steps_match_jax(five_steps):
    jm, tm = five_steps["jm"], five_steps["tm"]
    assert [w for w, _ in jm] == [w for w, _ in tm] == [32, 32, 64, 64, 64]
    for i, ((_, j), (_, t)) in enumerate(zip(jm, tm)):
        assert set(j) == set(t)
        for k, v in j.items():
            close(t[k], v, atol=1e-6, rtol=1e-4, msg=f"step {i} {k}")
    js, ts = five_steps["jstate"], five_steps["tstate"]
    assert ts.step == int(js.step) == STEPS
    np.testing.assert_array_equal(ts.alive.numpy(), js.alive)
    updates = {}
    for leaf, name in topt.FIELD_GROUP_OF.items():
        updates[name] = n = int(ts.opt[name].count)
        assert n == int(js.opt[name].adam.count), name
        atol = 2.0 * topt.DEFAULT_GROUPS[name].lr_init * n  # 0: an accumulating group, unmoved
        close(getattr(ts.field, leaf), getattr(js.field, leaf), atol=atol, rtol=0, msg=leaf)
    assert max(updates.values()) == STEPS
    for name, a, b in zip(js.stats._fields, js.stats, ts.stats):
        close(b, a, atol=1e-6, rtol=1e-3, msg=name)
    # a checkpoint at the end, and the port's run wrote a config both packages load
    tdir = five_steps["tcfg"].run_dir
    assert [p.name for p in (tdir / "checkpoints").iterdir()] == ["step_000000005.pt"]
    assert five_steps["tt"].dm.sampler_branch == "native"
    assert len(five_steps["tt"].data_wait_s) == STEPS


def test_trainer_configs_load_in_both_packages(five_steps):
    """A config.json written by either package loads in the other."""
    jdir = five_steps["jcfg"].run_dir
    jcfg = five_steps["jcfg"]
    tcfg = tcommon.config_from_json(jdir / "config.json")
    assert tcfg.model == five_steps["tcfg"].model
    assert (tcfg.data, tcfg.max_iterations, tcfg.seed) == (jcfg.data, jcfg.max_iterations, jcfg.seed)
    tt = five_steps["tt"]
    tt.save_config()
    back = j_config_from_json(tt.config.run_dir / "config.json")
    assert dataclasses.asdict(back.model) == dataclasses.asdict(tt.config.model)
    assert dataclasses.asdict(back) == {**dataclasses.asdict(tt.config),
                                        "model": dataclasses.asdict(back.model)}


def test_train_cli_runs_resumes_and_renders(scene, tmp_path):
    out = tmp_path / "out"
    common = ["--data", str(scene), "--output-dir", str(out), "--experiment-name", "cli",
              *CLI_ARGS]
    tr = t_train_cli.main([*common, "--max-iterations", "2", "--steps-per-save", "2"])
    run = out / "cli"
    assert tr.state.step == 2 and (run / "checkpoints" / "step_000000002.pt").exists()
    jcfg = j_config_from_json(run / "config.json")
    tcfg = tcommon.config_from_json(run / "config.json")
    assert jcfg.model.feature_dim == tcfg.model.feature_dim == 16
    assert tcfg.model.raster.max_tiles_per_gaussian == 16 and tcfg.capacity == 4096

    resumed = t_train_cli.main([*common, "--max-iterations", "3", "--steps-per-save", "3",
                                "--load-dir", str(run / "checkpoints")])
    assert resumed.state.step == 3 and len(resumed.data_wait_s) == 1

    _, trainer, state = tcommon.load_run(run, device="cpu")
    assert state.step == 3 and len(trainer.dm) == 4
    t_render_cli.main(["--run-dir", str(run), "--num-views", "2", "--device", "cpu"])
    metrics = json.loads((run / "renders" / "metrics.json").read_text())
    assert metrics["experiment_name"] == "cli" and len(metrics["results"]["per_view"]) == 2
    assert all(np.isfinite(r["psnr"]) and "depth_mae" in r and "psnr_masked" in r
               for r in metrics["results"]["per_view"])
    assert np.load(run / "renders" / "clip" / "00000_fea.npy").shape == (48, 64, 512)
    t_render_cli.main(["--run-dir", str(run), "--traj", "spiral", "--num-views", "3",
                       "--device", "cpu"])
    frames = sorted((run / "renders" / "traj").iterdir())
    assert [f.name for f in frames] == [f"{i:05d}.png" for i in range(3)]
    assert read_png(frames[2]).shape == (48, 64, 3)


def test_unported_options_raise(scene, tmp_path, monkeypatch):
    common = ["--data", str(scene), "--output-dir", str(tmp_path), *CLI_ARGS]
    # the NeRF zoo and generfacto resolve now (tests/test_torch_nerf_trainer.py
    # trains each); generfacto without guidance exits with its install hint
    for name in ("nerfacto", "vanilla-nerf", "instant-ngp", "neus-facto", "generfacto"):
        assert callable(get_method(name))
    monkeypatch.delenv("GGT_GUIDANCE", raising=False)
    monkeypatch.delenv("GGT_GUIDANCE_DIR", raising=False)
    with pytest.raises(SystemExit, match="GGT_GUIDANCE=color"):
        t_train_cli.main(["--method", "generfacto", *common])
    with pytest.raises(KeyError):
        get_method("no-such-method")
    # --viewer-port and --profiler trace run now (tests/test_torch_viewer.py,
    # tests/test_torch_tools.py); they reach the trainer's config
    args = t_train_cli.build_parser().parse_args([*common, "--viewer-port", "0", "--profiler",
                                                  "trace"])
    assert (args.viewer_port, args.profiler) == (0, "trace")
    # the CLI goes to the card by default and never falls back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda requested"):
        t_train_cli.main(["--data", str(scene), "--output-dir", str(tmp_path)])


@pytest.mark.parametrize("seeded", [True, False])
def test_setup_draws_from_the_seed(scene, seeded, tmp_path):
    """setup() initializes from the seed points, or at random without them,
    from one generator seeded with `seed`: two setups give the same state."""
    data = scene
    if not seeded:  # the same capture without sparse/0/points3D.txt
        data = tmp_path / "unseeded"
        data.mkdir()
        for sub in ("images", "transforms.json", "depths", "normals", "masks", "boundary_mask",
                    "features"):
            (data / sub).symlink_to(scene / sub)
    cfg = TTrainerConfig(data=data, output_dir=tmp_path, capacity=2400, random_init_points=500,
                         model=TConfig(raster=TRC(**SMALL_RASTER), **SMALL_MODEL))
    a, b = (t_make_trainer(cfg, device="cpu").setup() for _ in range(2))
    assert int(a.alive.sum()) == (2000 if seeded else 500) and a.field.capacity == 2400
    for x, y in zip(list(a.field) + list(a.fea_up.values()), list(b.field) + list(b.fea_up.values())):
        assert torch.equal(x, y)
    assert a.fea_up["layers.1.weight"].shape == (512, 128)
    assert float(a.fea_up["layers.0.weight"].abs().max()) <= 1 / 4  # U(-1/sqrt(16), +)
    assert (tmp_path / "gaussian-splatting" / "config.json").exists()


@pytest.mark.parametrize("step,factor", [(0, 2), (1, 2), (2, 1), (250, 1)])
def test_downscale_schedule(step, factor):
    cfg = TConfig(num_downscales=1, resolution_schedule=2)
    assert _downscale_factor(cfg, step) == factor == jtrainer._downscale_factor(cfg, step)


# --- TP = 2: K5 / K6's setting ------------------------------------------------------

TW2, TH2 = 96, 80  # tile 32: 3 x 3 = 9 tiles


def pairs2_inputs(n_channels, seed=23, n=350):
    scene = make_scene(seed, n, width=TW2, height=TH2, n_channels=n_channels)
    jp, _ = project_both(scene)
    jb = j_bin(jp, TW2, TH2, JRC(max_gaussians_per_tile=n), opacities=jnp.asarray(scene["opacities"]),
               build_table=False, keep_pairs=True)
    b = jb.pair_gidx.shape[0]
    starts = np.minimum(np.asarray(jb.pair_starts), b).astype(np.int32)
    counts = np.minimum(np.minimum(np.asarray(jb.tile_count), n),
                        np.maximum(b - starts, 0)).astype(np.int32)
    attrs = np.concatenate([np.asarray(jp.xys), np.asarray(jp.conics), scene["opacities"][:, None],
                            scene["colors"]], 1).astype(np.float32)
    bg = np.linspace(0.1, 0.9, n_channels).astype(np.float32)
    assert starts.shape == (9,) and counts.sum() > 0
    return jp, np.asarray(jb.pair_gidx), starts, counts, attrs, bg


@pytest.mark.parametrize("n_channels", [3, 39])
def test_tp2_plain_versions_match_jax_two_tile_kernels(n_channels, monkeypatch):
    monkeypatch.setattr(rc, "TP", 2)
    jp, gidx, starts, counts, attrs, bg = pairs2_inputs(n_channels)
    tw, n = -(-TW2 // 32), attrs.shape[0]
    kr = -(-n // rp.KC) * rp.KC
    pair_attrs = rp._gather_pairs(jnp.asarray(gidx), jp.xys, jp.conics, jnp.asarray(attrs[:, 5]),
                                  jnp.asarray(attrs[:, 6:]), kr)
    ref = rp._call_fwd_pairs2(jnp.asarray(starts), jnp.asarray(counts), pair_attrs,
                              jnp.asarray(bg)[None], tw, 32, 9, n_channels, kr, interpret=True)
    before = _build.launches.copy()
    got = rc.composite_pairs_fwd(T(gidx), T(starts), T(counts), T(attrs), T(bg), tw, 32,
                                 two_tile=True)
    for name, a, b in zip(("out", "alpha", "logt"), ref, got):
        close(b, a, atol=1e-5, rtol=1e-4, msg=name)
    # ncomp bounds the backward's walk, which stops at min(ncomp, count). An
    # uncut pixel's ncomp is its walk rounded up to 128 rows; the JAX kernel
    # walks a tile pair to the longer of the two, so only the clamped value
    # is the same function
    cnt = counts[:, None]
    np.testing.assert_array_equal(np.minimum(got[3].numpy(), cnt), np.minimum(np.asarray(ref[3]), cnt))
    assert (np.asarray(ref[3]) != got[3].numpy()).any()  # the pair walk is longer somewhere

    rng = np.random.default_rng(3)
    g_out = rng.normal(size=got[1].shape + (n_channels,)).astype(np.float32)
    g_alpha = rng.normal(size=got[1].shape).astype(np.float32)
    gref = rp._call_bwd_pairs2(jnp.asarray(starts), jnp.asarray(counts), pair_attrs, jnp.asarray(bg),
                               jnp.asarray(g_out), jnp.asarray(g_alpha), ref[2], ref[3], tw, 32, kr,
                               interpret=True)
    gref = np.asarray(gref)[: gidx.shape[0], : 6 + n_channels]
    ggot = rc.composite_pairs_bwd(T(gidx), T(starts), T(counts), T(attrs), T(bg), T(g_out),
                                  T(g_alpha), got[2], got[3], tw, 32, two_tile=True)
    for name, lo, hi in (("dxy", 0, 2), ("dconic", 2, 5), ("dopacity", 5, 6),
                         ("dcolor", 6, 6 + n_channels)):
        close_scaled(ggot[:, lo:hi], gref[:, lo:hi], 1e-5, msg=name)
    # CPU tensors: the plain versions, no kernel launch
    assert _build.launches == before


def test_tp2_composite_and_grads_match_jax(monkeypatch):
    """composite_pair_stream under TP = 2 in both packages: the port's
    autograd entry takes the two-tile path, and its outputs and VJP match
    the JAX vjp through `_call_fwd_pairs2` / `_call_bwd_pairs2`."""
    monkeypatch.setattr(rc, "TP", 2)
    monkeypatch.setattr(rp, "TP", 2)
    calls = []
    fwd, bwd = rc.composite_pairs_fwd, rc._pairs_bwd_unchecked
    monkeypatch.setattr(rc, "composite_pairs_fwd",
                        lambda *a, **k: calls.append(("fwd", k)) or fwd(*a, **k))
    monkeypatch.setattr(rc, "_pairs_bwd_unchecked",
                        lambda *a, **k: calls.append(("bwd", k)) or bwd(*a, **k))
    jp, gidx, starts, counts, attrs, bg = pairs2_inputs(39, seed=24)
    tw, k = -(-TW2 // 32), attrs.shape[0]
    args = (jnp.asarray(attrs[:, 0:2]), jnp.asarray(attrs[:, 2:5]), jnp.asarray(attrs[:, 5]),
            jnp.asarray(attrs[:, 6:]), jnp.asarray(bg))
    (out, alpha), vjp = jax.vjp(
        lambda *a: rp.composite_pair_stream(jnp.asarray(gidx), jnp.asarray(starts),
                                            jnp.asarray(counts), *a, tw, 32, k_cap=k), *args)
    rng = np.random.default_rng(4)
    g_out = rng.normal(size=out.shape).astype(np.float32)
    g_alpha = rng.normal(size=alpha.shape).astype(np.float32)
    jgrads = vjp((jnp.asarray(g_out), jnp.asarray(g_alpha)))

    targs = [T(np.asarray(a)).requires_grad_(True) for a in args]
    tout, talpha = rc.composite_pair_stream(T(gidx), T(starts), T(counts), *targs, tw, 32, k_cap=k)
    close(tout, out, atol=1e-5, rtol=1e-4, msg="out")
    close(talpha, alpha, atol=1e-5, rtol=1e-4, msg="alpha")
    tgrads = torch.autograd.grad((tout * T(g_out)).sum() + (talpha * T(g_alpha)).sum(), targs)
    for name, a, b in zip(("xys", "conics", "opacities", "colors", "bg"), tgrads, jgrads):
        close_scaled(a, b, 1e-4, msg=name)
    assert calls == [("fwd", {"two_tile": True}), ("bwd", {"two_tile": True})]


def test_tp_setting_other_than_1_or_2_raises(monkeypatch):
    monkeypatch.setattr(rc, "TP", 3)
    jp, gidx, starts, counts, attrs, bg = pairs2_inputs(3)
    with pytest.raises(ValueError, match="must be 1 or 2"):
        rc.composite_pair_stream(T(gidx), T(starts), T(counts), T(attrs[:, 0:2]), T(attrs[:, 2:5]),
                                 T(attrs[:, 5]), T(attrs[:, 6:]), T(bg), 3, 32, k_cap=350)
    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, "-c", "import gaussiangrasper_torch.ops.rasterize_cuda"],
                         cwd=root, env={**os.environ, "GGT_TP": "3"}, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and "GGT_TP" in res.stderr
    res = subprocess.run([sys.executable, "-c", "import gaussiangrasper_torch.ops.rasterize_cuda "
                          "as rc; print(rc.TP)"], cwd=root, env={**os.environ, "GGT_TP": "2"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "2"
