"""PyTorch port vs the JAX package: the ray-marched trainer, the method
registry and the eval tools.

- `NerfTrainer`: three steps of nerfacto, depth-nerfacto, instant-ngp (one
  grid update, a dynamic batch), tensorf, neus and semantic-nerfw at
  tests/test_model_zoo.py's tiny sizes, from one converted state, on a
  ray-traced tabletop (64x48, 4 views); the port replays the JAX trainer's
  keys (`NerfTrainer.draws`) and draws the same pixels from the same numpy
  Generator. Metrics, and each step's total loss (every term and its
  weight: the JAX step's, taken from its value_and_grad), at atol 1e-6 /
  rtol 1e-4; parameters within 2 lr N, the GS trainer tests' tolerances
  (tests/test_torch_trainer.py). A checkpoint written after two steps
  resumes to the three-step state; one whose generator state this device
  cannot take raises.
- `get_method` for all 15 names, GGT_METHOD_CONFIGS registration, and every
  name but nerfacto-big / -huge for two steps through the train CLI
  in-process on the CPU, at its registered widths, on a 32x24 tabletop
  (checkpoint and renders/metrics.json with finite PSNR; generfacto under
  GGT_GUIDANCE=color writes generated.png, and without guidance exits with
  the JAX package's message). nerfacto-big and -huge (2^19- and 2^21-row
  tables, 15 s through the CLI here) are held by their NerfConfig and one
  render of 64 rays.
- The render CLI with a random-weight VGG16 .npz at GGT_VGG16_WEIGHTS: its
  lpips rows and mean within 1e-5 of the JAX render CLI's on the same
  (converted) run.
"""

import dataclasses
import functools
import importlib
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gaussiangrasper_torch.configs import methods as tmethods
from gaussiangrasper_torch.data.dataparsers.zoo import resolve_parser
from gaussiangrasper_torch.data.manager import FullImageDatamanager, SamplerConfig
from gaussiangrasper_torch.engine import nerf_trainer as tnt
from gaussiangrasper_torch.engine.weights import nerf_params_from_numpy
from gaussiangrasper_torch.models import nerf as tnerf
from gaussiangrasper_torch.scripts import render as t_render_cli
from gaussiangrasper_torch.scripts import train as t_train_cli
from gaussiangrasper_torch.utils import perceptual as tperc
from gaussiangrasper_torch.utils.image_io import read_png
from gaussiangrasper_tpu.configs import methods as jmethods
from gaussiangrasper_tpu.data.synthetic import generate_tabletop
from gaussiangrasper_tpu.engine import nerf_trainer as jnt
from gaussiangrasper_tpu.engine.trainer import TrainerConfig as JTrainerConfig
from gaussiangrasper_tpu.engine.trainer import make_trainer as j_make_trainer
from gaussiangrasper_tpu.models import nerf as jnerf
from gaussiangrasper_tpu.utils import perceptual as jperc
from tests.test_torch_nerf import flat_tree, jax_draws, tiny_kwargs

STEPS = 3
NAMES = ["nerfacto", "nerfacto-big", "nerfacto-huge", "vanilla-nerf", "depth-nerfacto", "mipnerf",
         "instant-ngp", "instant-ngp-bounded", "tensorf", "dnerf", "semantic-nerfw",
         "phototourism", "neus", "neus-facto", "generfacto"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return generate_tabletop(tmp_path_factory.mktemp("tabletop") / "scene", width=64, height=48,
                             n_views=4, feature_downscale=2)


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    return generate_tabletop(tmp_path_factory.mktemp("tabletop32") / "scene", width=32,
                             height=24, n_views=3, feature_downscale=2, seed_points=300)


# the methods' trainer settings at tiny widths
TRAINER_CASES = {
    "nerfacto": ({"use_proposal": True, "num_proposal_samples": (8, 8)}, {}),
    "depth-nerfacto": ({}, dict(depth_lambda=0.1)),
    "instant-ngp": ({}, dict(use_occupancy_grid=True, dynamic_batch=True, grid_resolution=8,
                             target_num_samples=2048)),
    "tensorf": ({}, dict(tensorf_reg_lambda=5e-4)),
    "neus": ({}, dict(eikonal_lambda=0.1)),
    "semantic-nerfw": ({"num_semantic_classes": 8}, dict(semantic_lambda=0.1)),
}
FIELD_OF = {"nerfacto": "nerfacto", "depth-nerfacto": "nerfacto", "instant-ngp": "instant-ngp",
            "tensorf": "tensorf", "neus": "neus", "semantic-nerfw": "nerfacto"}


class JaxKeys:
    """The JAX NerfTrainer's key sequence: one split for init in setup(),
    then one a grid update and one a step, as `NerfTrainer.draws`."""

    def __init__(self, seed, cfg, grid_resolution):
        self.key, _ = jax.random.split(jax.random.PRNGKey(seed))
        self.cfg, self.res = cfg, grid_resolution

    def __call__(self, kind, num_rays):
        self.key, sub = jax.random.split(self.key)
        if kind == "grid":
            return {"cell_jitter": np.asarray(jax.random.uniform(sub, (self.res ** 3, 3)))}
        return jax_draws(self.cfg, sub, num_rays)


def trainer_configs(name, scene, out):
    mkw, tkw = TRAINER_CASES[name]
    kw = dict(data=scene, experiment_name=name, max_iterations=STEPS, steps_per_save=STEPS,
              rays_per_batch=64, steps_per_log=1000, **tkw)
    model = tiny_kwargs(FIELD_OF[name], **mkw)
    return (jnt.NerfTrainerConfig(**kw, output_dir=out / "jax", model=jnerf.NerfConfig(**model)),
            tnt.NerfTrainerConfig(**kw, output_dir=out, model=tnerf.NerfConfig(**model)))


def port_trainer(scene, tcfg):
    outputs = resolve_parser(Path(scene), "auto").parse()
    dm = FullImageDatamanager(outputs, SamplerConfig(), seed=0, device="cpu")
    return tnt.NerfTrainer(tcfg, dm)


@pytest.mark.parametrize("name", list(TRAINER_CASES))
def test_nerf_trainer_matches_jax(name, scene, tmp_path, monkeypatch):
    jcfg, tcfg = trainer_configs(name, scene, tmp_path)
    jt = jnt.NerfTrainer(jcfg, j_make_trainer(JTrainerConfig(data=scene)).dm)
    jt.setup()
    jmetrics, jgrids, jlosses = [], [], []
    grid_fn, plain_step = jnt._grid_update, jnt._nerf_step.__wrapped__
    vag = jax.value_and_grad

    @functools.wraps(plain_step)  # its signature, for static_argnames
    def step_with_total(*a, **k):
        """The JAX step, returning its value_and_grad's loss as well: a
        fresh jit of the same function, traced with value_and_grad wrapped
        to keep the (outermost) loss it computes."""
        seen = []

        def keeping(fun, **kw):
            inner = vag(fun, **kw)

            def run(*args):
                res = inner(*args)
                seen.append(res[0][0])
                return res
            return run

        with monkeypatch.context() as m:
            m.setattr(jax, "value_and_grad", keeping)
            p, o, metrics = plain_step(*a, **k)
        return p, o, {**metrics, "total": seen[-1]}

    jstep = jax.jit(step_with_total, static_argnames=("cfg",), donate_argnums=(0, 1))

    def recorded_step(*a, **k):
        p, o, m = jstep(*a, **k)
        jlosses.append(float(m.pop("total")))
        jmetrics.append({key: float(v) for key, v in m.items()})
        return p, o, m

    def recorded_grid(*a, **k):
        g = grid_fn(*a, **k)
        jgrids.append(np.asarray(g.density))
        return g

    monkeypatch.setattr(jnt, "_nerf_step", recorded_step)
    monkeypatch.setattr(jnt, "_grid_update", recorded_grid)
    np_params = jax.tree.map(np.asarray, jt.params)  # before train() donates them
    jt.train()

    tt = port_trainer(scene, tcfg)
    tt.setup()
    tt.field.load_state_dict(nerf_params_from_numpy(np_params, tcfg.model).state_dict())
    tt.draws = JaxKeys(tcfg.seed, jcfg.model, tcfg.grid_resolution)
    grids, losses = [], []
    grid_update, nerf_loss = tnt.grid_update, tnt.nerf_loss
    monkeypatch.setattr(tnt, "grid_update",
                        lambda *a: grids.append(grid_update(*a)) or grids[-1])
    monkeypatch.setattr(tnt, "nerf_loss",
                        lambda *a: losses.append(nerf_loss(*a)) or losses[-1])
    tt.train()

    assert len(tt.history) == len(jmetrics) == len(losses) == len(jlosses) == STEPS
    for i, (tm, jm) in enumerate(zip(tt.history, jmetrics)):
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], atol=1e-6, rtol=1e-4, err_msg=f"{k} @ {i}")
    for i, ((total, mse), want) in enumerate(zip(losses, jlosses)):
        total = float(total.detach())
        assert total > float(mse)  # the terms beyond the rgb mse are there
        np.testing.assert_allclose(total, want, atol=1e-6, rtol=1e-4, err_msg=f"total @ {i}")
    if jcfg.dynamic_batch:
        assert "num_rays_per_batch" in tt.history[0] and "num_samples" in tt.history[0]
    assert len(grids) == len(jgrids) == (1 if jcfg.use_occupancy_grid else 0)
    for tg, jg in zip(grids, jgrids):
        np.testing.assert_allclose(tg.density.numpy(), jg, atol=1e-6, rtol=1e-4)
    tol = 2 * jcfg.lr * STEPS
    jflat = flat_tree(jax.tree.map(np.asarray, jt.params))
    for n, p in tt.field.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jflat[n], atol=tol, rtol=0, err_msg=n)
    ckpts = sorted((tmp_path / name / "checkpoints").iterdir())
    assert [c.name for c in ckpts] == ["step_000000003.pt"]


def test_checkpoint_resumes_the_run(scene, tmp_path):
    """Two steps, a save, a fresh trainer that loads it and takes the third:
    the state of three steps in one go (grid, sizer, Adam and both
    generators included), to the rounding of the hash table's scatter-add,
    whose CPU accumulation order varies from run to run. A checkpoint whose
    generator state this device cannot take raises."""
    _, tcfg = trainer_configs("instant-ngp", scene, tmp_path / "full")
    full = port_trainer(scene, tcfg)
    full.setup()
    full.train()
    half_cfg = dataclasses.replace(tcfg, output_dir=tmp_path / "half", max_iterations=2)
    half = port_trainer(scene, half_cfg)
    half.setup()
    half.train()
    resumed = port_trainer(scene, dataclasses.replace(half_cfg, max_iterations=STEPS))
    resumed.setup()
    assert resumed.load(half_cfg.run_dir / "checkpoints" / "step_000000002.pt") == 2
    resumed.train()
    for (n, a), b in zip(full.field.state_dict().items(), resumed.field.state_dict().values()):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=1e-5, msg=n)
    assert torch.equal(full.grid.density, resumed.grid.density)  # updated at step 0 only
    assert full.history[2].keys() == resumed.history[0].keys()
    for k, v in full.history[2].items():
        assert resumed.history[0][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    # a generator state of another kind of device (a CUDA one is 16 bytes)
    payload = torch.load(half_cfg.run_dir / "checkpoints" / "step_000000002.pt",
                         weights_only=True)
    payload["generator"] = torch.zeros(16, dtype=torch.uint8)
    torch.save(payload, tmp_path / "card.pt")
    with pytest.raises(ValueError, match="kind of device that wrote it"):
        resumed.load(tmp_path / "card.pt")


def test_get_method_and_registration(monkeypatch):
    assert set(tmethods.METHODS) == set(jmethods.METHODS) == set(NAMES) | {"gaussian-splatting"}
    for name in NAMES:
        assert callable(tmethods.get_method(name))
    assert not hasattr(tmethods, "NOT_PORTED")
    with pytest.raises(KeyError):
        tmethods.get_method("no-such-method")
    monkeypatch.setenv("GGT_METHOD_CONFIGS", "my-method=json:dumps")
    importlib.reload(tmethods)
    try:
        assert tmethods.get_method("my-method") is json.dumps
    finally:
        monkeypatch.delenv("GGT_METHOD_CONFIGS")
        importlib.reload(tmethods)
    assert "my-method" not in tmethods.METHODS


def test_generfacto_gate_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("GGT_GUIDANCE", raising=False)
    monkeypatch.delenv("GGT_GUIDANCE_DIR", raising=False)
    args = t_train_cli.build_parser().parse_args(
        ["--method", "generfacto", "--data", str(tmp_path), "--output-dir", str(tmp_path),
         "--device", "cpu"])
    with pytest.raises(SystemExit) as jerr:
        jmethods.get_method("generfacto")(args)
    with pytest.raises(SystemExit) as terr:
        tmethods.get_method("generfacto")(args)
    assert str(terr.value) == str(jerr.value) and "GGT_GUIDANCE=color" in str(terr.value)
    monkeypatch.setenv("GGT_GUIDANCE_DIR", str(tmp_path / "missing"))
    with pytest.raises(SystemExit, match="locally cached"):
        tmethods.get_method("generfacto")(args)


BIG = ("nerfacto-big", "nerfacto-huge")  # 2^19 / 2^21-row tables: checked without the CLI


@pytest.mark.parametrize("name", [n for n in NAMES if n not in BIG])
def test_every_method_trains_through_the_cli(name, small_scene, tmp_path, monkeypatch):
    monkeypatch.setenv("GGT_GUIDANCE", "color")
    out = t_train_cli.main(["--method", name, "--data", str(small_scene), "--output-dir",
                            str(tmp_path), "--experiment-name", name, "--max-iterations", "2",
                            "--steps-per-save", "2", "--device", "cpu"])
    run = tmp_path / name
    if name == "generfacto":
        assert read_png(run / "generated.png").shape == (64, 64, 3)
        assert all(torch.isfinite(p).all() for p in out.parameters())
        return
    assert out.config.model == tnerf.NerfConfig(**dataclasses.asdict(
        _jax_model_config(name, len(out.dm))))
    assert [c.name for c in (run / "checkpoints").iterdir()] == ["step_000000002.pt"]
    rows = json.loads((run / "renders" / "metrics.json").read_text())
    assert [r["view"] for r in rows] == [0, 1, 2] and all(np.isfinite(r["psnr"]) for r in rows)
    assert read_png(run / "renders" / "00000.png").shape == (24, 32, 3)
    if name.startswith("instant-ngp"):  # the sizer's first bucket: 2^18 samples / 128
        assert [h["num_rays_per_batch"] for h in out.history] == [2048, 2048]


@pytest.mark.parametrize("name", BIG)
def test_big_nerfacto_configs_render(name):
    """The registered NerfConfig, and one forward and backward of 64 rays at
    its widths (the CLI path is nerfacto's)."""
    cells = dict(zip(tmethods.METHODS[name].__code__.co_freevars,
                     (c.cell_contents for c in tmethods.METHODS[name].__closure__)))
    cfg = tnerf.NerfConfig(field=cells["field"], **cells["model_kwargs"])
    assert cfg == tnerf.NerfConfig(**dataclasses.asdict(_jax_model_config(name, 1)))
    field = tnerf.init_nerf(cfg, seed=0, device="cpu")
    assert field.grid.table.shape == (16, 2 ** cfg.log2_hashmap_size, 2)
    from gaussiangrasper_torch.core.cameras import Camera
    from gaussiangrasper_torch.core.rays import generate_rays

    cam = Camera.create(30.0, 30.0, 16.0, 12.0, np.concatenate([np.eye(3), [[0], [0], [2]]], 1),
                        32, 24)
    coords = torch.stack(torch.meshgrid(torch.arange(8), torch.arange(8), indexing="ij"),
                         -1).reshape(-1, 2)
    out = tnerf.render_rays(field, generate_rays(cam, coords),
                            torch.Generator().manual_seed(0), cfg)
    assert out["rgb"].shape == (64, 3) and torch.isfinite(out["rgb"]).all()
    out["rgb"].sum().backward()
    assert field.grid.table.grad.abs().max() > 0


def _jax_model_config(name, num_views):
    """The NerfConfig the JAX registry builds for `name` (its _nerf closure's
    model kwargs)."""
    run = jmethods.METHODS[name]
    cells = dict(zip(run.__code__.co_freevars, (c.cell_contents for c in run.__closure__)))
    field, mkw = cells["field"], dict(cells["model_kwargs"] or {})
    if mkw.pop("_appearance_per_image", False):
        mkw["num_appearance_embeds"] = num_views
    return jnerf.NerfConfig(field=field, **mkw)


def test_render_cli_writes_lpips(scene, tmp_path, monkeypatch):
    """A JAX trainer run at step 0 (its config.json and Orbax checkpoint)
    through the JAX render CLI, and the same run converted to the port
    (config.json as written, the state through `train_state_from_numpy`)
    through the port's: the lpips rows and mean within 1e-5, both packages
    reading one random-weight .npz."""
    from gaussiangrasper_torch.engine.checkpoint import save_checkpoint as t_save_checkpoint
    from gaussiangrasper_tpu.engine import checkpoint as jckpt
    from gaussiangrasper_tpu.engine import trainer as jtrainer
    from gaussiangrasper_tpu.models.model import GaussianSplatConfig as JConfig
    from gaussiangrasper_tpu.ops.rasterize import RasterizeConfig as JRC
    from gaussiangrasper_tpu.scripts import render as j_render_cli
    from tests.test_torch_train import convert
    from tests.test_torch_trainer import SMALL_RASTER

    path = tmp_path / "vgg16.npz"
    np.savez(path, **jperc.random_weights(7))
    monkeypatch.setenv("GGT_VGG16_WEIGHTS", str(path))
    for mod in (jperc, tperc):
        mod.reset_cache()
    try:
        jcfg = jtrainer.TrainerConfig(
            data=scene, output_dir=tmp_path / "jax", experiment_name="gs", capacity=4096,
            model=JConfig(feature_dim=16, sh_degree=1, raster=JRC(**SMALL_RASTER)))
        jt = j_make_trainer(jcfg)
        jstate = jt.setup()
        jckpt.save_checkpoint(jcfg.ckpt_dir, jstate)
        j_render_cli.main(["--run-dir", str(jcfg.run_dir), "--num-views", "2"])
        want = json.loads((jcfg.run_dir / "renders" / "metrics.json").read_text())["results"]

        run = tmp_path / "port" / "gs"
        run.mkdir(parents=True)
        (run / "config.json").write_text((jcfg.run_dir / "config.json").read_text())
        t_save_checkpoint(run / "checkpoints", convert(jstate))
        t_render_cli.main(["--run-dir", str(run), "--num-views", "2", "--device", "cpu"])
        got = json.loads((run / "renders" / "metrics.json").read_text())["results"]
        assert len(got["per_view"]) == len(want["per_view"]) == 2
        np.testing.assert_allclose([r["lpips"] for r in got["per_view"]],
                                   [r["lpips"] for r in want["per_view"]], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got["lpips"], want["lpips"], atol=1e-5, rtol=0)
    finally:
        for mod in (jperc, tperc):
            mod.reset_cache()
