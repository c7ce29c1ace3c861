"""PyTorch port vs the JAX package: multi-scene training
(engine/multi_scene.py) and the CLIs' --mesh / several --data.

- Two scenes, two steps from one stacked state against the JAX
  `multi_scene_train_step`: test_torch_train.py's train-step tolerances
  (mean metrics atol 1e-6 / rtol 1e-4, parameters at 2 lr per update of
  their group); the shared fea_up equal across the port's scenes
  (bit-equal) and within 2 lr per update of the JAX one.
- Unshared: each scene's step is the single-scene `train_step`'s,
  bit-equal.
- `train_multi` over two gloo ranks (dp 2) against one process, and the
  update CLI's sharded fine-tune (--mesh 1,2, tile-sharded) against its
  single-device one: fields at atol 1e-6 (float32 sums of another order
  and thread count), alive masks and steps equal.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_engine as JE
from gaussiangrasper_torch.core.cameras import Camera as TCamera
from gaussiangrasper_torch.engine import checkpoint as tckpt
from gaussiangrasper_torch.engine import optimizers as topt
from gaussiangrasper_torch.engine.multi_scene import multi_scene_train_step as t_ms_step
from gaussiangrasper_torch.engine.train_state import train_step as t_step
from gaussiangrasper_torch.models.model import GaussianSplatConfig as TConfig
from gaussiangrasper_torch.ops.rasterize import RasterizeConfig as TRC
from gaussiangrasper_torch.scripts import train as t_train_cli
from gaussiangrasper_torch.scripts import update as t_update_cli
from gaussiangrasper_tpu.data.synthetic import SPHERES, generate_tabletop, move_object
from gaussiangrasper_tpu.engine.multi_scene import multi_scene_train_step as j_ms_step
from gaussiangrasper_tpu.engine.multi_scene import stack_states, unstack_states
from tests.test_multi_scene import build_scene
from tests.test_torch_core import close
from tests.test_torch_train import convert

STEPS = 2


def port_inputs(batches):
    cam = TCamera.create(30.0, 30.0, JE.W / 2, JE.H / 2, np.eye(4, dtype=np.float32)[:3], JE.W,
                         JE.H)
    return [cam] * len(batches), [{k: torch.tensor(np.asarray(v)) for k, v in b.items()}
                                  for b in batches]


TCFG = TConfig(feature_dim=JE.F, warmup_length=0,
               raster=TRC(tile_size=8, max_gaussians_per_tile=128))


@pytest.fixture(scope="module")
def scenes():
    """tests/test_multi_scene.py's two scenes (one fea_up init), converted
    into the port before the JAX step donates them, and two batches."""
    (s0, cam), (s1, _) = build_scene(0), build_scene(7)
    rng = np.random.default_rng(1)
    return dict(jax=[s0, s1], jcam=cam, torch=[convert(s0), convert(s1)],
                batches=[JE.tiny_batch(rng), JE.tiny_batch(rng)])


def test_two_scenes_match_jax(scenes):
    states = stack_states(scenes["jax"])
    jcams = jax.tree.map(lambda *ls: jnp.stack(ls), scenes["jcam"], scenes["jcam"])
    jbatches = jax.tree.map(lambda *ls: jnp.stack(ls), *scenes["batches"])
    tstates = scenes["torch"]
    cams, batches = port_inputs(scenes["batches"])
    for i in range(STEPS):
        states, jm = j_ms_step(states, jcams, jbatches, JE.small_cfg())
        tstates, tm = t_ms_step(tstates, cams, batches, TCFG)
        assert set(tm) == set(jm)
        for k, v in jm.items():
            close(tm[k], np.asarray(v), atol=1e-6, rtol=1e-4, msg=f"step {i} {k}")
    jout = [jax.tree.map(np.asarray, s) for s in unstack_states(states, 2)]
    updates = {"xyz": 0, "color": 0, "feature": 0, "opacity": STEPS, "scaling": STEPS,
               "rotation": STEPS}
    for ts, js in zip(tstates, jout):
        assert ts.step == int(js.step) == STEPS
        for leaf, name in topt.FIELD_GROUP_OF.items():
            close(getattr(ts.field, leaf), getattr(js.field, leaf),
                  atol=2.0 * topt.DEFAULT_GROUPS[name].lr_init * updates[name], rtol=0, msg=leaf)
        for i in range(2):
            close(ts.fea_up[f"layers.{i}.weight"], js.fea_up[f"w{i}"].T, atol=2.0 * 1e-3 * STEPS,
                  rtol=0, msg=f"w{i}")
    for k in tstates[0].fea_up:  # one shared fea_up
        assert torch.equal(tstates[0].fea_up[k], tstates[1].fea_up[k]), k
    np.testing.assert_array_equal(jout[0].fea_up["w0"], jout[1].fea_up["w0"])
    assert not torch.equal(tstates[0].field.means, tstates[1].field.means)


def test_unshared_up_net_is_the_single_scene_step(scenes):
    cams, batches = port_inputs(scenes["batches"])
    got, _ = t_ms_step(scenes["torch"], cams, batches, TCFG, share_up_net=False)
    for st, cam, b, g in zip(scenes["torch"], cams, batches, got):
        want, _ = t_step(st, cam, b, TCFG)
        for a, c in zip(g.field, want.field):
            assert torch.equal(a, c)
        for k in want.fea_up:
            assert torch.equal(g.fea_up[k], want.fea_up[k])
    assert not torch.equal(got[0].fea_up["layers.0.weight"], got[1].fea_up["layers.0.weight"])


# --- the CLIs -----------------------------------------------------------------------


KW = dict(width=64, height=48, n_views=4, feature_downscale=2, seed_points=300)
CLI = ["--capacity", "1024", "--feature-dim", "8", "--sh-degree", "1", "--device", "cpu"]


@pytest.fixture(scope="module")
def captures(tmp_path_factory):
    root = tmp_path_factory.mktemp("captures")
    return dict(root=root, scene=generate_tabletop(root / "scene", **KW))


def same_state(a, b, msg):
    assert a.step == b.step, msg
    np.testing.assert_array_equal(a.alive.numpy(), b.alive.numpy(), err_msg=msg)
    for name, x, y in zip(a.field._fields, a.field, b.field):
        close(x, y, atol=1e-6, rtol=0, msg=f"{msg} {name}")
    for k in a.fea_up:
        close(a.fea_up[k], b.fea_up[k], atol=1e-6, rtol=0, msg=f"{msg} {k}")


def test_train_cli_two_scenes_on_one_process_and_two_ranks(captures, tmp_path, capsys):
    """`--data a b` trains both scenes in this process; with `--mesh 2,2`
    over two gloo ranks, one scene each (gauss is unused there, as in the
    JAX package: F7). Both leave scene_<i>/checkpoints with one fea_up."""
    second = generate_tabletop(captures["root"] / f"second_{tmp_path.name}", seed=3, **KW)
    common = ["--data", str(captures["scene"]), str(second), "--max-iterations", "3",
              "--steps-per-save", "3", "--warmup-length", "0", "--refine-every", "2", *CLI]
    one = t_train_cli.main([*common, "--output-dir", str(tmp_path / "one")])
    t_train_cli.main([*common, "--output-dir", str(tmp_path / "two"), "--mesh", "2,2"])
    assert "gauss=2 is unused" in capsys.readouterr().out
    assert len(one) == 2 and all(s.step == 3 for s in one)
    for k in one[0].fea_up:
        assert torch.equal(one[0].fea_up[k], one[1].fea_up[k])
    for i in range(2):
        ckpts = [tckpt.load_checkpoint(tckpt.latest_checkpoint(
            tmp_path / run / "gaussian-splatting" / f"scene_{i}" / "checkpoints"))
            for run in ("one", "two")]
        same_state(*ckpts, msg=f"scene {i}")
        same_state(ckpts[0], one[i], msg=f"scene {i} returned")
    with pytest.raises(ValueError, match="not divisible by dp=3"):
        t_train_cli.main([*common, "--output-dir", str(tmp_path / "three"), "--mesh", "3,1"])


def test_update_cli_mesh_matches_one_device(tmp_path):
    """The update CLI's fine-tune through the sharded host loop (--mesh
    1,2: two gloo ranks, tile-sharded) against its single-device one, from
    one trainer run. At 128x96 (2 x 2 tiles at the fine-tune's half
    resolution) the default band budget holds every pair; at 64x48 the
    whole capture is one tile, one band takes every pair, and the budget
    drops some, as in the JAX package."""
    kw = dict(KW, width=128, height=96)
    scene = generate_tabletop(tmp_path / "scene", **kw)
    after, obj = move_object(tmp_path / "after", **kw)
    out = tmp_path / "out"
    t_train_cli.main(["--data", str(scene), "--output-dir", str(out),
                      "--max-iterations", "2", "--steps-per-save", "2", *CLI])
    centre = SPHERES[1][0]
    np.save(tmp_path / "obj.npy", centre + 1.2 * (obj - centre))
    move = np.eye(4)
    move[:3, 3] = (-0.55, 0.45, 0.0)
    np.save(tmp_path / "move.npy", move)
    runs = {}
    for name, extra in (("single", []), ("mesh", ["--mesh", "1,2"])):
        run = tmp_path / name
        shutil.copytree(out / "gaussian-splatting", run)
        t_update_cli.main(["--run-dir", str(run), "--edit-object", str(tmp_path / "obj.npy"),
                           "--transform-npy", str(tmp_path / "move.npy"), "--after-data",
                           str(after), "--max-iterations", "3", "--device", "cpu",
                           *extra])
        runs[name] = tckpt.load_checkpoint(run / "edit" / "checkpoints" / "step_009999999.pt")
    assert runs["mesh"].step == 3
    same_state(runs["mesh"], runs["single"], "update")
