"""PyTorch port vs the JAX package: camera pose optimization.

Inputs are made with numpy from a seed and go through both packages on the
CPU (JAX forced there by conftest). Tolerances and their reasons:

- The exp maps and `apply_pose_delta`: 1e-6 absolute (float32 sin / cos
  and 3 x 3 products in another order).
- The gradient of a render with respect to the delta: 1e-4 of its max
  |entry|, the render gradients' bar in tests/test_torch_train.py. The
  delta's gradient is a sum over every Gaussian's projected centre and
  conic (and the SH view directions), in float32, in another order.
- `train_step` across the camera_opt group's boundary (step 99): the
  banked accumulator at 1e-4 relative; the first Adam update of a group
  moves each entry by lr times the sign of its summed gradient, so the
  deltas and the field are held at 2 lr N, as in tests/test_torch_train.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiangrasper_torch.core import pose_opt as tpo
from gaussiangrasper_torch.core.cameras import Camera as TCamera
from gaussiangrasper_torch.engine import checkpoint as tckpt
from gaussiangrasper_torch.engine import optimizers as topt
from gaussiangrasper_torch.engine import train_state as tts
from gaussiangrasper_torch.engine.trainer import TrainerConfig as TTrainerConfig
from gaussiangrasper_torch.engine.trainer import make_trainer as t_make_trainer
from gaussiangrasper_torch.engine.weights import train_state_from_numpy
from gaussiangrasper_torch.models.gaussian_field import FIELD_KEYS
from gaussiangrasper_torch.models.model import GaussianSplatConfig as TConfig
from gaussiangrasper_torch.models.model import render as t_render
from gaussiangrasper_torch.ops.rasterize import RasterizeConfig as TRC
from gaussiangrasper_tpu.core import pose_opt as jpo
from gaussiangrasper_tpu.data.synthetic import generate_tabletop
from gaussiangrasper_tpu.engine.train_state import init_train_state as j_init
from gaussiangrasper_tpu.engine.train_state import train_step as j_step
from gaussiangrasper_tpu.models.gaussian_field import init_random as j_init_random
from gaussiangrasper_tpu.models.model import render as j_render
from tests.test_torch_core import T, close
from tests.test_torch_train import (H, W, cameras, close_scaled, configs, fea_up_arrays,
                                    jfield_of, make_batch, make_field, opt_numpy, tfield_of)

MODES = ("SO3xR3", "SE3")
SMALL_MODEL = dict(feature_dim=16, sh_degree=1, num_downscales=1, resolution_schedule=2,
                   warmup_length=30, refine_every=100, pose_opt_mode="SO3xR3")
SMALL_RASTER = dict(tile_size=16, max_gaussians_per_tile=1024, tile_chunk=4,
                    max_tiles_per_gaussian=16)
PERTURB = (0.06, -0.04, 0.0, 0.0, 0.0, 0.02)  # tests/test_pose_opt.py's perturbation


def convert(jstate):
    """The JAX TrainState (pose deltas and camera_opt group included) as
    the port's."""
    return train_state_from_numpy(
        {k: np.array(getattr(jstate.field, k)) for k in FIELD_KEYS}, np.array(jstate.alive),
        jax.tree.map(np.array, jstate.fea_up), opt_numpy(jstate),
        {k: np.array(v) for k, v in jstate.stats._asdict().items()}, int(jstate.step),
        pose=None if jstate.pose is None else np.array(jstate.pose))


# --- the exp maps --------------------------------------------------------------------


@pytest.mark.parametrize("mode", ("off",) + MODES)
def test_apply_pose_delta_matches_jax(mode):
    rng = np.random.default_rng(len(mode))
    deltas = np.concatenate([rng.normal(scale=0.3, size=(6, 6)), np.zeros((1, 6))])
    deltas = deltas.astype(np.float32)
    deltas[1, 3:] = [np.pi / 2, 0, 0]
    poses = rng.normal(size=(7, 3, 4)).astype(np.float32)
    for pose, delta in zip(poses, deltas):
        got = tpo.apply_pose_delta(T(pose), T(delta), mode)
        want = jpo.apply_pose_delta(jnp.asarray(pose), jnp.asarray(delta), mode)
        close(got, want, atol=1e-6, rtol=0, msg=mode)
        close(tpo.exp_map_so3(T(delta[3:])), jpo.exp_map_so3(jnp.asarray(delta[3:])), atol=1e-6,
              rtol=0, msg="so3")
        close(tpo.exp_map_se3(T(delta)), jpo.exp_map_se3(jnp.asarray(delta)), atol=1e-6, rtol=0,
              msg="se3")
    close(tpo.exp_map_so3(T(deltas[:, 3:])), jpo.exp_map_so3(jnp.asarray(deltas[:, 3:])),
          atol=1e-6, rtol=0, msg="batched so3")
    if mode == "off":
        p = T(poses[0])
        assert tpo.apply_pose_delta(p, T(deltas[0]), mode) is p
    assert tpo.init_pose_deltas(4).shape == (4, 6) and not tpo.init_pose_deltas(4).any()


# --- the render's gradient with respect to the delta -----------------------------------


@pytest.mark.parametrize("mode,start", [("SO3xR3", "moved"), ("SE3", "moved"), ("SE3", "zero")])
def test_render_pose_gradient_matches_jax(mode, start):
    field, alive = make_field(5)
    jcfg, tcfg = configs(pose_opt_mode=mode)
    jcam, tcam = cameras()
    rng = np.random.default_rng(6)
    C = tcfg.num_channels
    wimg = rng.normal(size=(H, W, C)).astype(np.float32)
    walpha = rng.normal(size=(H, W)).astype(np.float32)
    delta = np.zeros(6, np.float32) if start == "zero" else \
        np.array([0.02, -0.015, 0.01, 0.01, -0.02, 0.005], np.float32)
    step = 9  # SH degree 3: the view directions carry a gradient

    def jloss(d):
        o = j_render(jfield_of(field), jnp.asarray(alive), jcam, step, jcfg, pose_delta=d)
        img = jnp.concatenate([o["rgb"], o["feature"], o["depth"], o["normal"]], -1)
        return jnp.sum(img * wimg) + jnp.sum(o["alpha"] * walpha)

    jg = jax.jit(jax.grad(jloss))(jnp.asarray(delta))
    d = T(delta).requires_grad_(True)
    o = t_render(tfield_of(field), torch.as_tensor(alive), tcam, step, tcfg, pose_delta=d)
    img = torch.cat([o["rgb"], o["feature"], o["depth"], o["normal"]], -1)
    (g,) = torch.autograd.grad((img * T(wimg)).sum() + (o["alpha"] * T(walpha)).sum(), [d])
    assert float(g.abs().min()) > 0
    close_scaled(g, jg, 1e-4, msg=mode)


def _small_scene():
    """tests/test_pose_opt.py's scene: 150 random Gaussians 3 units ahead
    of an identity camera, 48x32, from the JAX package's init_random."""
    field, alive = j_init_random(jax.random.PRNGKey(0), 150, extent=1.5, feature_dim=4,
                                 init_scale=0.08)
    field = {k: np.array(getattr(field, k)) for k in FIELD_KEYS}
    field["means"] = field["means"] + np.array([0.0, 0.0, -3.0], np.float32)
    return field, np.array(alive)


@pytest.mark.parametrize("mode", MODES)
def test_perturbed_camera_recovers_through_render(mode):
    """tests/test_pose_opt.py's recovery at its setting and with its bar:
    60 Adam(1e-2) steps on the delta alone; the final loss under 0.2x the
    first and a translation above 1e-3 (tile 16, as the CPU tests render)."""
    field, alive = _small_scene()
    cfg = TConfig(feature_dim=4, pose_opt_mode=mode, raster=TRC(**SMALL_RASTER))
    tf = tfield_of(field)
    alive = torch.as_tensor(alive)
    c2w = torch.eye(4)[:3]
    cam = TCamera.create(60.0, 60.0, 24.0, 16.0, c2w, 48, 32)
    with torch.no_grad():
        target = t_render(tf, alive, cam, 0, cfg)["rgb"]
    perturbed = dataclasses.replace(cam, camera_to_world=tpo.apply_pose_delta(
        c2w, T(np.array(PERTURB, np.float32)), "SO3xR3"))
    delta = torch.zeros(6, requires_grad=True)
    opt = torch.optim.Adam([delta], lr=1e-2)
    losses = []
    for _ in range(60):
        loss = torch.mean((t_render(tf, alive, perturbed, 0, cfg, pose_delta=delta)["rgb"]
                           - target) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.2 * losses[0], (losses[0], losses[-1])
    assert float(delta.detach()[:3].abs().max()) > 1e-3


# --- the train step ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def boundary_steps():
    """JAX and port states with pose deltas (3 cameras, SO3xR3) from one
    converted state at step 98, stepped twice on camera 1: step 98 banks
    the camera_opt gradient, step 99 applies it."""
    field, alive = make_field(0)
    batch = make_batch(1)
    jcfg, tcfg = configs(pose_opt_mode="SO3xR3")
    jcam, tcam = cameras()
    pose0 = np.random.default_rng(2).normal(scale=0.01, size=(3, 6)).astype(np.float32)
    jstate = j_init(jax.random.PRNGKey(2), jfield_of(field), jnp.asarray(alive),
                    {k: jnp.asarray(v) for k, v in fea_up_arrays().items()},
                    pose=jnp.asarray(pose0))
    jstate = jstate._replace(step=jnp.asarray(98, jnp.int32))
    tstate = convert(jstate)
    jb = {**{k: jnp.asarray(v) for k, v in batch.items()}, "cam_idx": jnp.asarray(1, jnp.int32)}
    tb = {**{k: torch.as_tensor(v) for k, v in batch.items()}, "cam_idx": torch.tensor(1)}
    out = []
    for _ in range(2):
        jstate, jm = j_step(jstate, jcam, jb, jcfg)
        tstate, tm = tts.train_step(tstate, tcam, tb, tcfg)
        out.append(dict(jstate=jax.tree.map(np.array, jstate), jm=jax.tree.map(np.array, jm),
                        tstate=tstate, tm=tm))
    return pose0, out


def test_train_step_banks_then_applies_pose_like_jax(boundary_steps):
    pose0, (first, second) = boundary_steps
    # step 98: the deltas stay, the gradient is banked
    ts, js = first["tstate"], first["jstate"]
    np.testing.assert_array_equal(ts.pose.numpy(), pose0)
    close_scaled(ts.opt["camera_opt"].accum, js.opt["camera_opt"].accum, 1e-4, msg="accum")
    assert float(ts.opt["camera_opt"].accum[1].abs().min()) > 0
    assert not ts.opt["camera_opt"].accum[[0, 2]].any()
    for s in (first, second):
        assert set(s["tm"]) == set(s["jm"]) and "grad_norm/camera_opt" in s["tm"]
        for k, v in s["jm"].items():
            close(s["tm"][k], v, atol=1e-6, rtol=1e-4, msg=k)
    # step 99: one Adam update of the camera_opt group, the accumulator reset
    ts, js = second["tstate"], second["jstate"]
    lr = float(topt.lr_at(topt.DEFAULT_GROUPS["camera_opt"], 99))
    assert ts.step == int(js.step) == 100
    assert int(ts.opt["camera_opt"].count) == int(js.opt["camera_opt"].adam.count) == 1
    close(ts.pose, js.pose, atol=2.0 * lr, rtol=0, msg="pose")
    moved = np.abs(ts.pose.numpy() - pose0)
    assert moved[1].min() > 0.5 * lr and not moved[[0, 2]].any()
    close_scaled(ts.opt["camera_opt"].mu, js.opt["camera_opt"].adam.mu, 1e-4, msg="mu")
    close_scaled(ts.opt["camera_opt"].nu, js.opt["camera_opt"].adam.nu, 1e-4, msg="nu")
    assert not ts.opt["camera_opt"].accum.any()
    for leaf, name in topt.FIELD_GROUP_OF.items():
        n = int(ts.opt[name].count)
        close(getattr(ts.field, leaf), getattr(js.field, leaf),
              atol=2.0 * topt.DEFAULT_GROUPS[name].lr_init * n, rtol=0, msg=leaf)


def test_refine_step_keeps_the_pose_moments(boundary_steps):
    """The JAX package's refine_step raises on the (num_cameras, 6) moments
    (ROADMAP.md, F6); the port cleans only the field groups' moments."""
    ts = boundary_steps[1][1]["tstate"]
    _, tcfg = configs(pose_opt_mode="SO3xR3")
    out = tts.refine_step(dataclasses.replace(ts, step=600), tcfg, W, H, num_train_data=3)
    for part in ("mu", "nu"):
        torch.testing.assert_close(getattr(out.opt["camera_opt"], part),
                                   getattr(ts.opt["camera_opt"], part), atol=0, rtol=0)
    torch.testing.assert_close(out.pose, ts.pose, atol=0, rtol=0)


def test_checkpoint_carries_pose_and_loads_without(boundary_steps, tmp_path):
    ts = boundary_steps[1][1]["tstate"]
    path = tckpt.save_checkpoint(tmp_path / "pose", ts)
    back = tckpt.load_checkpoint(path)
    torch.testing.assert_close(back.pose, ts.pose, atol=0, rtol=0)
    for part in ("mu", "nu", "count", "accum"):
        torch.testing.assert_close(getattr(back.opt["camera_opt"], part),
                                   getattr(ts.opt["camera_opt"], part), atol=0, rtol=0)
    # a checkpoint written before pose deltas were saved has no "pose" key
    payload = torch.load(path, weights_only=True)
    del payload["pose"], payload["opt"]["camera_opt"]
    old = tmp_path / "old" / tckpt.STEP_FMT.format(7)
    old.parent.mkdir()
    torch.save(payload, old)
    back = tckpt.load_checkpoint(old)
    assert back.pose is None and "camera_opt" not in back.opt and back.step == ts.step


# --- the trainer --------------------------------------------------------------------------



def test_trainer_with_pose_opt_on_the_cpu(tmp_path):
    """Four trainer steps with SO3xR3 pose deltas and a camera_opt period of
    2: every batch carries its view's index, the deltas of the views drawn
    move and stay finite, and the checkpoint carries them."""
    scene = generate_tabletop(tmp_path / "scene", width=64, height=48, n_views=4,
                              feature_downscale=2)
    tcfg = TTrainerConfig(data=scene, output_dir=tmp_path / "runs", max_iterations=4,
                          steps_per_save=4, capacity=4096,
                          model=TConfig(raster=TRC(**SMALL_RASTER), **SMALL_MODEL))
    tt = t_make_trainer(tcfg, device="cpu")
    tt.setup()
    assert tt.state.pose.shape == (4, 6) and not tt.state.pose.any()
    groups = dict(topt.DEFAULT_GROUPS, camera_opt=dataclasses.replace(
        topt.DEFAULT_GROUPS["camera_opt"], accum=2))
    drawn = []
    t_step = tts.train_step

    def spy(state, cam, batch, cfg):
        drawn.append(int(batch["cam_idx"]))
        return t_step(state, cam, batch, cfg, groups)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tts, "train_step", spy)
        ts = tt.train()
    assert ts.step == 4 and int(ts.opt["camera_opt"].count) == 2
    assert sorted(drawn) == [0, 1, 2, 3]  # one epoch: each view once
    assert bool(torch.isfinite(ts.pose).all()) and bool((ts.pose.abs().amax(1) > 0).all())
    back = tckpt.load_checkpoint(tckpt.latest_checkpoint(tcfg.ckpt_dir))
    torch.testing.assert_close(back.pose, ts.pose, atol=0, rtol=0)
